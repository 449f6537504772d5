"""Readings that set a cell's limits, several seeds in one process (not
run by the benchmark's runs):

  python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 \
      [--control fp8,half_batch,unchanged] [--port-fp32]

Without ``--control``: per seed, the run's set-up and warm-up call, then
the cell's check, as ``run.py`` makes them, without the window (the lower
readings: sound runs of the program). With ``--control``: per seed, the
reference put in the program's place, in the lower precision or with each
fault named (the upper readings). ``--port-fp32`` runs the port with its
bf16 autocast off (a witness). One JSON line per seed (and kind) on
standard output, and each number's largest (program) or smallest (each
control) reading last.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import sys

import run


def port_in_fp32() -> None:
    """A witness, not a control: the port's bf16 autocast switched off and
    TF32 with it, so that the port computes in float32 as the reference
    does; the numbers then read float32 rounding where the two agree."""
    import creamfl_tpu_torch.models.pcme as pcme

    from reference import strict_fp32

    pcme.compute_dtype = lambda dtype, device: contextlib.nullcontext()
    strict_fp32()


def _program(cell, ctx):
    import torch

    st = cell.phase.setup(ctx)
    record = cell.phase.warm(st)
    out = cell.phase.outputs(st)
    cell.phase.release(st)
    del st
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return cell.phase.check(ctx, record, out)


def readings(cell_name: str, seeds, controls=(), smoke: bool = False):
    """{kind: each limited number's largest (program, kind "program") or
    smallest (each control) reading over ``seeds``}."""
    import torch

    from benchlib import registry

    cell = registry.Cell(cell_name, smoke=smoke)
    dev = torch.device("cpu" if smoke else "cuda:0")
    rows = {}
    for seed in seeds:
        ctx = run.Ctx(cell, seed, dev, smoke)
        with contextlib.redirect_stdout(sys.stderr):
            if controls:
                by_kind = cell.phase.control(ctx, controls)
            else:
                by_kind = {"program": _program(cell, ctx)}
        for kind, numbers in by_kind.items():
            print(json.dumps({"seed": seed, "kind": kind, **numbers}),
                  flush=True)
            rows.setdefault(kind, []).append(numbers)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for kind, found in rows.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick((r[k] for r in found if math.isfinite(r[k])),
                                 default=float("nan"))
                         for k, v in found[0].items()
                         if not k.startswith("_")}
    print(json.dumps({"workload": cell_name, "seeds": list(seeds),
                      "largest program, smallest control": summary}),
          flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--port-fp32", action="store_true",
                   help="run the port in float32 (a witness)")
    a = p.parse_args(argv)
    if a.port_fp32:
        port_in_fp32()
    readings(a.workload, [int(s) for s in a.seeds.split(",")],
             tuple(a.control.split(",")) if a.control else ())
    return 0


if __name__ == "__main__":
    run.reexec(__file__)
    sys.exit(main())
