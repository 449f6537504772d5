"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``creamfl_tpu_torch`` (and
``chip_smoke``) and lists what got loaded. ``creamfl_tpu_torch`` itself
starts with ``creamfl_tpu``, so the check matches the JAX package by its
exact name or its ``creamfl_tpu.`` prefix, not by a plain prefix.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import creamfl_tpu_torch
names = ["creamfl_tpu_torch", "chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(creamfl_tpu_torch.__path__,
                                          "creamfl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def _is_forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return (root in ("jax", "jaxlib", "flax", "optax", "chex")
            or root.startswith("jax_") or root == "creamfl_tpu")


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert len(result["imported"]) >= 20, result["imported"]
    bad = [m for m in result["loaded"] if _is_forbidden(m)]
    assert not bad, bad


def test_forbidden_name_check():
    assert _is_forbidden("creamfl_tpu")
    assert _is_forbidden("creamfl_tpu.ops.gallery")
    assert _is_forbidden("jax.numpy") and _is_forbidden("flax.linen")
    assert not _is_forbidden("creamfl_tpu_torch")
    assert not _is_forbidden("creamfl_tpu_torch.ops.gallery")
