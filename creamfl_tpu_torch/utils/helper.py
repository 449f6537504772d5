"""Experiment helpers (reference `src/utils/helper.py`).

Port of the JAX package's ``utils/helper.py`` (``set_seed``,
``get_save_dirs``, ``to_one_hot``), with the server checkpoint that
``MMFL._save`` writes.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict

import numpy as np
import torch

from creamfl_tpu_torch.parallel.mesh import is_main
from creamfl_tpu_torch.utils.serialize import to_host


def set_seed(seed: int) -> None:
    """Seed Python's, NumPy's and torch's global generators (the reference's
    Helper.set_seed); torch's seeds every device's default generator."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def get_save_dirs(exp_dir: str, name: str) -> Dict[str, str]:
    """Experiment directory tree (reference helper.py:96-109)."""
    base = os.path.join(exp_dir, name)
    dirs = {
        "base": base,
        "logs": os.path.join(base, "logs"),
        "checkpoints": os.path.join(base, "checkpoints"),
        "results": os.path.join(base, "results"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def to_one_hot(labels, n_dims: int) -> torch.Tensor:
    """Integer labels -> float32 one-hot [..., n_dims] (reference Utils.py
    to_one_hot); labels outside [0, n_dims) give zero rows, as
    ``jax.nn.one_hot``'s do."""
    labels = torch.as_tensor(labels).long()
    return (labels[..., None] == torch.arange(
        n_dims, device=labels.device)).float()


def save_checkpoint(path: str, payload: Dict[str, Any]) -> str:
    """``torch.save`` of ``payload`` (state dicts and plain values) with
    every tensor copied to the host; returns ``path``. In a process group
    only rank 0 writes. Round checkpoints are ``utils.checkpoint``'s."""
    if not is_main():
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(to_host(payload), path)
    return path
