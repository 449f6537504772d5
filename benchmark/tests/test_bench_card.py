"""On the card: a short run of each cell, traced and not, comes out
correct, with the result's device block and, traced, every per-layer
metric of the cell. Skips itself without a card (decided in the test)."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["server_train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 101 + trace), "--seconds", "1",
         "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        spec = json.load(open(os.path.join(BENCH, "workloads",
                                           cell + ".json")))
        assert set(line["metrics"]) == set(spec["metrics"])
        assert line["device"]["busy_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
