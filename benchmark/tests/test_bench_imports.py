"""Nothing the benchmark runs imports JAX or the JAX package: the harness,
every phase, every metric reader and the reference, imported in a fresh
process, leave no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``creamfl_tpu`` (the port, ``creamfl_tpu_torch``, is another
name)."""

import glob
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

SCRIPT = r"""
import glob, importlib, json, os, sys
bench, repo = sys.argv[1], sys.argv[2]
sys.path[:0] = [bench, repo]
import run, readings
from benchlib import device, loader_wait, peaks, program, registry, trace
import reference.data, reference.models, reference.server, reference.train
for kind in ("phases", "metrics", "configs"):
    for path in sorted(glob.glob(os.path.join(bench, kind, "*.py"))):
        registry.load_module(kind, os.path.basename(path)[:-3])
from creamfl_tpu_torch.federation import rounds
from creamfl_tpu_torch import main
print(json.dumps(sorted(m for m in sys.modules)))
"""


def test_no_jax_in_what_the_benchmark_runs():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT, BENCH, REPO],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "creamfl_tpu"}, sorted(
        tops & {"jax", "jaxlib", "flax", "creamfl_tpu"})
    assert "creamfl_tpu_torch" in tops
    assert glob.glob(os.path.join(BENCH, "phases", "*.py"))


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path[:0]=[sys.argv[1]]; "
            "import reference.server, reference.models, reference.data, "
            "reference.train; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, BENCH],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert "creamfl_tpu_torch" not in out.stdout
    assert "'jax'" not in out.stdout
