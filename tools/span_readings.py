"""The span metrics of a benchmark cell, read through the program's
recorder (``creamfl_tpu_torch/utils/profiling.py``) on the card.

  python3 tools/span_readings.py --workload server_train \
      --seeds 3100000101,3100000102 --seconds 51 [--cost 6] [--out FILE]

The benchmark (``benchmark/``) is read, not changed. Per seed, in one
process, as ``benchmark/run.py`` makes a run: the cell's set-up and warm-up
call; the window (whole phase calls, each between two
``torch.cuda.synchronize()``, for ``--seconds``) with the recorder on and
the benchmark's loader-wait timer beside it; one more call under
``torch.profiler`` inside a second recording, in the benchmark's
``bench.call`` range; then, with ``--cost N``, N pairs of calls with the
recorder off and on, in turns. One JSON line per seed on standard output
(and in ``--out``):

- ``data_wait_share``: ``creamfl.data.next`` seconds on the phase thread
  over the window's, %; ``loader_wait_share`` beside it (the benchmark's
  timer, from outside the program);
- ``update_host_share``: ``creamfl.engine.update`` seconds over the
  window's, %;
- ``update_device_share``: the device seconds of the kernels launched in
  ``creamfl.engine.update`` over the profiled call's busy seconds, %;
- ``idle_in_step_share``: the profiled call's idle seconds under a
  ``creamfl.engine.*`` span on the phase thread over all its idle seconds,
  %;
- ``window_rebuilds``: ``graph.captures`` + ``ops.builds`` in the window;
- ``mamba_host_share``: the ``creamfl.mamba.*`` spans' seconds on the
  phase thread over the window's, %; ``mamba_device_share``: the device
  seconds of the kernels launched in them over the profiled call's busy
  seconds, % (the forward's: the backward runs on autograd's thread,
  outside the spans; the benchmark's ``ssm_device_share`` reads both);
  both absent without a Granite-4.0-H tower;
- ``idle_split``: the call's idle seconds by the innermost span open on
  the phase thread ("" for none), and their sum against wall − busy;
- ``device_by_span``, ``spans_a_step``, ``counters``; ``clock``: each span's
  recorded start and end against its ``record_function`` range in the
  profile (ns; small and positive where both read one clock);
- ``cost``: the calls' seconds with the recorder off and on.

``--smoke`` rehearses it on the CPU at the configuration's ``smoke`` sizes
(no device events there: the device numbers read nothing).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
for _p in (BENCH, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run  # noqa: E402  (benchmark/run.py)

ENGINE = "creamfl.engine."
MAMBA = tuple(f"creamfl.mamba.{p}" for p in ("proj", "conv", "scan", "norm"))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _round_call(phase):
    """The phase's call without a recording of its own: the decoder
    towers' phases turn the recorder on inside their call (to count the
    held experts' pairs), and here the recorder is this script's; their
    base phase (``_BASE``, ``server_train``'s) makes the same call."""
    return getattr(phase, "_BASE", phase).call


def _timed_call(phase, st, n, dev) -> float:
    _sync(dev)
    t = time.perf_counter()
    _round_call(phase)(st, n)
    _sync(dev)
    return time.perf_counter() - t


def _profile(fn, dev):
    """``fn()`` under ``torch.profiler`` in the benchmark's call range;
    the raw events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchlib.trace import CALL_RANGE

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        with record_function(CALL_RANGE):
            _sync(dev)
            fn()
            _sync(dev)
    return list(prof.profiler.kineto_results.events())


def _clock(spans, events):
    """Each recorded span against the ``record_function`` range of its
    name that starts nearest to it: the range's start minus the span's,
    and the span's end minus the range's, ns."""
    by_name = {}
    for e in events:
        if e.name().startswith("creamfl.") and e.device_type().name == "CPU":
            by_name.setdefault(e.name(), []).append(e.start_ns())
    for starts in by_name.values():
        starts.sort()
    ranges = {(e.name(), e.start_ns()): e.end_ns() for e in events
              if e.name() in by_name}
    starts, ends = [], []
    for s in spans:
        cand = by_name.get(s.name)
        if not cand:
            continue
        i = bisect.bisect_left(cand, s.start_ns)
        near = min(cand[max(i - 1, 0):i + 1],
                   key=lambda x: abs(x - s.start_ns))
        starts.append(near - s.start_ns)
        ends.append(s.end_ns - ranges[(s.name, near)])
    if not starts:
        return {"pairs": 0}
    return {"pairs": len(starts),
            "start_ns": [min(starts), statistics.median(starts), max(starts)],
            "end_ns": [min(ends), statistics.median(ends), max(ends)]}


def readings(cell, seed: int, seconds: float, cost: int, smoke: bool):
    import torch

    from benchlib import loader_wait
    from benchlib.trace import CALL_RANGE, Trace
    from creamfl_tpu_torch.utils import profiling

    dev = torch.device("cpu" if smoke else "cuda:0")
    phase = cell.phase
    ctx = run.Ctx(cell, seed, dev, smoke)
    st = phase.setup(ctx)
    phase.warm(st)
    _sync(dev)
    first = phase.steps_so_far(st)
    calls, n = [], 1
    with loader_wait.LoaderWait() as waits, profiling.recording() as snap:
        _sync(dev)
        t0 = time.perf_counter()
        while True:
            calls.append(_timed_call(phase, st, n, dev))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    steps = phase.steps_so_far(st) - first
    with profiling.recording() as call_snap:
        events = _profile(lambda: _round_call(phase)(st, n), dev)
    n += 1
    split = profiling.device_split(events, CALL_RANGE)
    trace = Trace(events) if dev.type == "cuda" else None
    off, on = [], []
    for i in range(cost):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            if traced:
                with profiling.recording():
                    on.append(_timed_call(phase, st, n, dev))
            else:
                off.append(_timed_call(phase, st, n, dev))
            n += 1
    phase.release(st)
    del st

    idle = split.wall_s - split.busy_s
    step_idle = sum(v for k, v in split.idle_s.items()
                    if k.startswith(ENGINE))
    counters = snap.counters
    mamba_device = sum(split.device_s.get(s, 0.0) for s in MAMBA)
    out = {
        "seed": seed, "device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu"),
        "window_s": window_s, "calls": len(calls), "call_s": calls,
        "steps": steps,
        "data_wait_share": 100 * snap.on_thread("creamfl.data.next")
        / window_s,
        "loader_wait_share": 100 * waits.seconds / window_s,
        "update_host_share": 100 * snap.on_thread(ENGINE + "update")
        / window_s,
        "update_device_share": (100 * split.device_s.get(
            ENGINE + "update", 0.0) / split.busy_s if split.busy_s
            else None),
        "idle_in_step_share": 100 * step_idle / idle if idle else None,
        "window_rebuilds": (counters.get("graph.captures", 0)
                            + counters.get("ops.builds", 0)),
        "mamba_host_share": (100 * sum(snap.on_thread(s) for s in MAMBA)
                             / window_s if "mamba.tokens" in counters
                             else None),
        "mamba_device_share": (100 * mamba_device / split.busy_s
                               if mamba_device and split.busy_s else None),
        "wall_s": split.wall_s, "busy_s": split.busy_s,
        "idle_split": dict(sorted(split.idle_s.items())),
        "idle_split_sum": sum(split.idle_s.values()), "idle_s": idle,
        "device_by_span": dict(sorted(split.device_s.items())),
        "host_s_by_span": {k: v for k, v in sorted(snap.seconds.items())},
        "spans_a_step": (len(snap.spans) + snap.dropped) / max(steps, 1),
        "counts": dict(sorted(snap.counts.items())),
        "counters": dict(sorted(counters.items())),
        "clock": _clock(call_snap.spans, events),
        "cost": {"off_s": off, "on_s": on},
    }
    if trace is not None:
        out["benchmark_trace"] = {"busy_s": trace.busy_s,
                                  "wall_s": trace.wall_s,
                                  "idle_share": 100 * trace.idle_share}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost", type=int, default=0,
                   help="pairs of calls with the recorder off and on")
    p.add_argument("--out", default=None, help="also append the lines here")
    p.add_argument("--smoke", action="store_true",
                   help="the CPU at the configuration's smoke sizes")
    a = p.parse_args(argv)
    from benchlib import registry

    cell = registry.Cell(a.workload, smoke=a.smoke)
    for seed in (int(s) for s in a.seeds.split(",")):
        line = json.dumps(readings(cell, seed, a.seconds, a.cost, a.smoke))
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    run.reexec(__file__)
    sys.exit(main())
