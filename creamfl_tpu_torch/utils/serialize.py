"""Serialization helpers.

The port's own copy of the JAX package's ``utils/serialize.py``:
``flatten_dict`` matches the reference's pandas-json_normalize-based
flattening of nested score dicts (`src/utils/serialize_utils.py:9`);
``to_host`` copies the tensors of a nested payload (state dicts,
optimizer states) to the host before ``torch.save``. On a mesh every rank
holds every state whole (``parallel/mesh.py``), so there is no counterpart
of ``tree_to_numpy``'s mesh gather; rank 0 alone writes
(``utils/helper.py:save_checkpoint``, ``utils/checkpoint.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def flatten_dict(d: Dict[str, Any], sep: str = "_",
                 _parent: str = "") -> Dict[str, Any]:
    """Flatten nested dicts: {'a': {'b': 1}} -> {'a_b': 1}."""
    out: Dict[str, Any] = {}
    for key, val in d.items():
        flat_key = f"{_parent}{sep}{key}" if _parent else str(key)
        if isinstance(val, dict):
            out.update(flatten_dict(val, sep=sep, _parent=flat_key))
        else:
            out[flat_key] = val
    return out


def to_host(x: Any) -> Any:
    """``x`` with every tensor in its dicts, lists and tuples detached and
    copied to the CPU; other values as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x
