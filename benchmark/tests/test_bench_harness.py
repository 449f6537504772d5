"""The harness finds a cell, its configuration, its phase and its metrics
by name: a throwaway cell, written as new files into a copy of the
benchmark's folder, runs without an edit to any file there; and the last
line of standard output has the result's shape."""

import json
import os
import shutil
import textwrap

import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOY_PHASE = '''
"""A phase of a few matrix products on the CPU."""
import torch


class State:
    def __init__(self, ctx):
        self.x = torch.randn(64, 64, generator=torch.Generator().manual_seed(
            ctx.seed))
        self.steps = 0


def setup(ctx):
    return State(ctx)


def call(st, n):
    for _ in range(4):
        st.x = torch.tanh(st.x @ st.x.T / 8)
        st.steps += 1
    return {}


def warm(st):
    call(st, 0)
    return {"x": st.x.clone()}


def steps_so_far(st):
    return st.steps


def flops(st, steps):
    return steps * 2 * 64 ** 3


def failed(st, first):
    return 0


def outputs(st):
    return st.x.clone()


def release(st):
    pass


def check(ctx, record, out, fp8=False):
    return {"finite": 0.0 if torch.isfinite(out).all() else 1.0}
'''

TOY_METRIC = '''
UNIT = "calls"


def read(records):
    return float(len(records["calls"]))
'''


def _toy_copy(tmp_path):
    root = str(tmp_path / "bench")
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {os.path.relpath(os.path.join(d, f), root): open(
        os.path.join(d, f), "rb").read()
        for d, _, fs in os.walk(root) for f in fs}
    files = {
        "workloads/toy_cell.json": json.dumps({
            "name": "toy_cell", "config": "toy_config", "traffic": "toy",
            "phase": "toy_phase", "chips": 1, "why": "a harness test",
            "metrics": ["toy_calls", "mfu"], "limits": {"finite": 0.5}}),
        "configs/toy_config.json": json.dumps({
            "name": "toy_config", "source": "a test", "model": {},
            "port_flags": [], "reduced": {}}),
        "configs/toy_config_flops.py": "def per_sample(model):\n"
                                       "    return {'forward': 1.0}\n",
        "phases/toy_phase.py": textwrap.dedent(TOY_PHASE),
        "metrics/toy_calls.py": textwrap.dedent(TOY_METRIC),
    }
    for rel, text in files.items():
        with open(os.path.join(root, rel), "w") as f:
            f.write(text)
    return root, before


def _last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_a_new_cell_is_only_new_files(tmp_path, capsys):
    root, before = _toy_copy(tmp_path)
    argv = ["--workload", "toy_cell", "--seed", str(2 ** 31 + 7),
            "--seconds", "0.05", "--trace", "0"]
    assert run.main(argv, smoke=True, root=root) == 0
    line = _last_line(capsys)
    assert line["correct"] is True
    assert line["attempted"] == 4 * line["window"]["calls"]
    # On the CPU no profiled call reads the device: setup_s alone.
    assert set(line["metrics"]) == {"setup_s"}
    assert run.main(argv[:-1] + ["1"], smoke=True, root=root) == 0
    line = _last_line(capsys)
    assert line["metrics"]["toy_calls"] == {
        "value": float(line["window"]["calls"]), "unit": "calls"}
    assert "mfu" in line["metrics"]
    for rel, data in before.items():
        with open(os.path.join(root, rel), "rb") as f:
            assert f.read() == data, rel


def test_last_line_shape(tmp_path, capsys):
    root, _ = _toy_copy(tmp_path)
    assert run.main(["--workload", "toy_cell", "--seed", "3", "--seconds",
                     "0.05", "--trace", "0"], smoke=True, root=root) == 0
    line = _last_line(capsys)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["device"]["count"] == 1
    assert "memory_peak_bytes" in line["device"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    assert line["checks"]["finite"] == {"value": 0.0, "limit": 0.5}


def test_no_card_no_result(tmp_path, capsys, monkeypatch):
    import torch

    root, _ = _toy_copy(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "toy_cell", "--seed", "3", "--seconds",
                   "0.05", "--trace", "0"], root=root)
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""


class _Trace:
    device_events, busy_s = 3, 4.05


def test_end_to_end_metrics_of_a_card_run():
    facts = {"calls": [{"seconds": 8.0}] * 6, "window_s": 48.0,
             "setup_s": 30.0, "failed": 0, "attempted": 192,
             "memory_peak_bytes": 1, "trace": _Trace()}
    cell = type("Cell", (), {"metrics": {}})()
    line = run.result(cell, facts, {}, False, {"count": 1})
    assert line["metrics"] == {"call_device_s": {"value": 4.05, "unit": "s"},
                               "setup_s": {"value": 30.0, "unit": "s"}}
