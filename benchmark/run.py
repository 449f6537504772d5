"""The benchmark of the PyTorch/CUDA port, one cell a run.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``), a round phase (``phases/<phase>.py``) and its
per-layer metrics (``metrics/<metric>.py``); ``benchlib/registry.py``
finds each by name. A run:

1. needs the cards the cell asks for, else it exits non-zero and prints no
   result;
2. set-up: builds the round through the port's own constructors and makes
   one warm-up call of the phase (round 0), which compiles and captures
   what the phase uses and whose first steps the check reads; ``setup_s``
   runs from the process's start to here;
3. the window: whole phase calls (rounds 1, 2, ...), each between two
   ``torch.cuda.synchronize()``, until ``--seconds`` have passed (the
   window's seconds over its calls are the per-layer ``phase_wall_s``);
4. after the window one more call runs under ``torch.profiler``:
   ``call_device_s`` is the seconds in which the device ran an operation
   during it; with ``--trace 1`` the window also times the loader waits,
   and the result carries the cell's per-layer metrics, the device's busy
   time and a breakdown instead of the end-to-end metrics;
5. the program's state is freed, and the phase's check runs the plain
   reference (``reference/``) and compares: every number with its limit
   (the cell's ``limits``) is printed last on standard error and, under
   ``checks``, last in the result line, the last line of standard output.

It fixes ``PYTHONHASHSEED`` (the port's synthetic BERT ids hash words) by
running itself again once, and keeps every compile cache in fixed folders
inside the checkout (``.bench_cache/``). It refuses to print a result if
JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CACHE = os.path.join(REPO, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "creamfl_tpu")
_T0_ENV = "CREAMFL_BENCH_T0"

for _p in (HERE, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def run_env() -> dict:
    """The environment a run executes in: one hash seed, and every cache
    at a fixed path inside the checkout."""
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = "0"
    env["USE_FLAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        env[var] = os.path.join(CACHE, sub)
    return env


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Ctx:
    """What a phase and its check read: the seed, the device, the cell and
    its configuration (with its ``smoke`` sizes merged in on the CPU)."""

    def __init__(self, cell, seed: int, device, smoke: bool):
        self.seed, self.device, self.smoke = seed, device, smoke
        self.cell, self.config, self.flops = cell.spec, cell.config, \
            cell.flops
        self.root = cell.root
        from benchlib.registry import merge

        self.ref_cfg = (merge(cell.config, cell.config.get("smoke", {}))
                        if smoke else cell.config)
        self.model_cfg = self.ref_cfg["model"]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, ctx, seconds: float, trace: bool, t_start: float):
    """Set-up, window, trace; returns (record, outputs, facts) with the
    program's state freed."""
    import torch

    from benchlib import loader_wait, trace as tracing

    phase, dev = cell.phase, ctx.device
    cuda = dev.type == "cuda"
    st = phase.setup(ctx)
    record = phase.warm(st)
    _sync(dev)
    facts = {"setup_s": time.time() - t_start}
    first = phase.steps_so_far(st)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    waits = loader_wait.LoaderWait() if trace else contextlib.nullcontext()
    calls, n = [], 1
    with waits:
        _sync(dev)
        t0 = time.perf_counter()
        while True:
            _sync(dev)
            t_call = time.perf_counter()
            calls.append(phase.call(st, n))
            _sync(dev)
            calls[-1]["seconds"] = time.perf_counter() - t_call
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        facts["window_s"] = time.perf_counter() - t0
    facts["calls"] = calls
    facts["window_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                  if cuda else 0)
    if trace:
        facts["loader_wait_s"] = waits.seconds
    facts["attempted"] = phase.steps_so_far(st) - first
    facts["failed"] = phase.failed(st, first)
    facts["flops"] = phase.flops(st, facts["attempted"])
    if cuda:
        # A phase may open ranges of its own around the calls a reader
        # asks for (``traced_call``), and hand over what it counted there
        # (``trace_facts``).
        traced = getattr(phase, "traced_call", phase.call)
        facts["trace"] = tracing.profile_call(lambda: traced(st, n))
        facts.update(getattr(phase, "trace_facts", lambda s: {})(st))
    facts["memory_peak_bytes"] = max(
        setup_peak, torch.cuda.max_memory_allocated(dev) if cuda else 0)
    outputs = phase.outputs(st)
    phase.release(st)
    del st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return record, outputs, facts


def judge(cell, numbers: dict) -> dict:
    """Each compared number beside its limit (the cell's ``limits``)."""
    checks = {}
    for name, limit in cell.limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
    return checks


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def result(cell, facts: dict, checks: dict, trace: bool,
           device_info: dict) -> dict:
    calls = facts["calls"]
    if trace:
        metrics = {}
        for name, reader in cell.metrics.items():
            value = reader.read(facts)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    else:
        metrics = {"setup_s": {"value": facts["setup_s"], "unit": "s"}}
        tr = facts.get("trace")
        if tr is not None and tr.device_events:
            metrics = dict(call_device_s={"value": tr.busy_s, "unit": "s"},
                           **metrics)
    device = dict(device_info, memory_peak_bytes=facts["memory_peak_bytes"])
    out = {
        "correct": (facts["failed"] == 0 and all(
            _finite(c["value"]) and c["value"] <= c["limit"]
            for c in checks.values())),
        "attempted": facts["attempted"], "failed": facts["failed"],
        "metrics": metrics, "device": device,
        "window": {"seconds": facts["window_s"], "calls": len(calls),
                   "call_s": [c["seconds"] for c in calls],
                   "setup_s": facts["setup_s"]},
    }
    tr = facts.get("trace")
    if trace and tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s, tr.wall_s
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps[:10]]}
    out["checks"] = checks
    return out


def main(argv=None, smoke: bool = False, root: str = None) -> int:
    """One run; returns the exit code. ``smoke`` (tests only) runs the
    cell on the CPU at the configuration's ``smoke`` sizes, without the
    look for a card; ``root`` is the benchmark folder to read."""
    import torch

    from benchlib import device as devinfo
    from benchlib import registry

    args = parse(argv)
    t_start = float(os.environ.get(_T0_ENV, T_START))
    cell = registry.Cell(args.workload, root or registry.ROOT, smoke)
    if smoke:
        dev = torch.device("cpu")
    else:
        try:
            devinfo.require_cards(cell.chips)
        except devinfo.NoCard as e:
            print(f"benchmark: {e}", file=sys.stderr)
            return 3
        dev = torch.device("cuda:0")
        torch.cuda.set_device(dev)
    info = devinfo.describe(dev, cell.chips)
    ctx = Ctx(cell, args.seed, dev, smoke)
    with contextlib.redirect_stdout(sys.stderr):
        record, outputs, facts = measure(cell, ctx, args.seconds,
                                         bool(args.trace), t_start)
        found = forbidden_modules()
        if found:
            print(f"benchmark: JAX or the JAX package was imported: {found}",
                  file=sys.stderr)
            return 4
        numbers = cell.phase.check(ctx, record, outputs)
    checks = judge(cell, numbers)
    out = result(cell, facts, checks, bool(args.trace), info)
    for k, v in numbers.get("_worst", {}).items():
        print(f"worst leaf of {k}: {v}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was imported: {found}",
              file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def reexec(script: str) -> None:
    """Run ``script`` again in ``run_env()`` (once: the process's start
    time travels along for ``setup_s``)."""
    if os.environ.get(_T0_ENV) is not None:
        return
    env = run_env()
    env[_T0_ENV] = repr(T_START)
    for sub in ("triton", "torch_extensions", "inductor", "nv"):
        os.makedirs(os.path.join(CACHE, sub), exist_ok=True)
    sys.stdout.flush()
    os.execve(sys.executable, [sys.executable, os.path.abspath(script)]
              + sys.argv[1:], env)


if __name__ == "__main__":
    reexec(__file__)
    sys.exit(main())
