"""Phase: the server's train epoch, ``MMFL._server_train_epoch()``.

A call is what the round does for its ``server_train`` phase: round ``n``'s
seeding (``_seed_round``) and learning rate (``set_round_lr``), then one
epoch over the public loader. The round's own method runs: a change to how
the epoch steps (chunks, graphs, another loader) is measured as it is.

Everything the harness and the check read is what a call leaves behind,
never a tap on a step: the steps from the optimizer's own step counts, the
losses from the round's report to its logger ("server epoch loss"), and
the server's state. Set-up runs round 0's epoch through the round's own
method in four calls on one live iterator of the public loader's round-0
epoch: its first batch, its second, its third, then the rest. So the same
``MMFL``, call and feed that the window then drives are read after the
first step (each leaf's first gradient, from AdamP's first moment; each
BatchNorm's running statistics, which the first forward moved) and after
the third (each leaf's change), and each of the first three reports is
one step's loss. The reference (``reference/server.py``) follows the same
three steps from the seed.
"""

from __future__ import annotations

import gc
import itertools
import math
import re
from typing import Dict

import numpy as np
import torch

from benchlib import program

_EPOCH_LOSS = re.compile(r"^server epoch loss (\S+)$")
CHECK_STEPS = 3


class State:
    def __init__(self, ctx):
        self.ctx = ctx
        self.args, self.algo = program.build_round(
            program.port_argv(ctx.config, ctx.cell, ctx.seed, ctx.smoke),
            ctx.device)
        self.per_sample = ctx.flops.per_sample(ctx.model_cfg)["train"]
        self.batch = ctx.ref_cfg["data"]["batch"]
        self.first_report = 0


def setup(ctx) -> State:
    return State(ctx)


def call(st: State, n: int) -> Dict:
    algo = st.algo
    algo._seed_round(n)
    algo.server.set_round_lr(algo.server_state, n)
    algo._server_train_epoch()
    return {}


def epoch_losses(st: State, first: int = 0):
    """The epoch losses the round reported from its ``first``-th report on
    (NaN where a report does not parse)."""
    out = []
    for line in st.algo.logger.lines[first:]:
        m = _EPOCH_LOSS.match(line)
        if m:
            try:
                out.append(float(m.group(1)))
            except ValueError:
                out.append(float("nan"))
    return out


class _Next:
    """The next ``k`` batches of one live epoch iterator, as a loader the
    round's method iterates (once)."""

    def __init__(self, it, k: int):
        self.it, self.k = it, k

    def __iter__(self):
        return itertools.islice(self.it, self.k)

    def __len__(self) -> int:
        return self.k


def warm(st: State) -> Dict:
    """Round 0's epoch, one step a call for its first ``CHECK_STEPS``
    steps and then the rest in one call, and what the check reads of the
    server after the first and the third step."""
    algo = st.algo
    state = algo.server_state
    algo._seed_round(0)
    algo.server.set_round_lr(state, 0)
    loader = algo.datasets["pub_train"]
    n, it = len(loader), iter(loader)
    start = {k: p.detach().clone()
             for k, p in program.leaves(state).items()}
    record = {"round": 0}
    try:
        for i, size in enumerate([1] * min(CHECK_STEPS, n)
                                 + [max(n - CHECK_STEPS, 0)]):
            if size == 0:
                continue
            algo.datasets["pub_train"] = _Next(it, size)
            algo._server_train_epoch()
            if i == 0:
                record["grads"] = program.first_grads(state)
                record["running"] = program.running_stats(state)
            if i == min(CHECK_STEPS, n) - 1:
                record["change"] = program.norms({
                    k: p.detach() - start[k]
                    for k, p in program.leaves(state).items()})
                del start
        record["left_over"] = sum(1 for _ in it)
    finally:
        algo.datasets["pub_train"] = loader
    record["losses"] = epoch_losses(st)[:CHECK_STEPS]
    record["steps"] = steps_so_far(st)
    st.first_report = len(algo.logger.lines)
    return record


def steps_so_far(st: State) -> int:
    return program.optimizer_steps(st.algo.server_state)


def flops(st: State, steps: int) -> float:
    """The model operations of ``steps`` train steps of a full batch."""
    return steps * st.batch * st.per_sample


def failed(st: State, first_step: int) -> int:
    """Every step of the window counts as failed if a window call reported
    a loss that is not finite, or a weight is not finite at its end."""
    steps = steps_so_far(st) - first_step
    losses = epoch_losses(st, st.first_report)
    weights = torch.stack([torch.isfinite(p).all() for p in
                           program.leaves(st.algo.server_state).values()])
    if not (all(math.isfinite(x) for x in losses) and bool(weights.all())):
        return steps
    return 0


def outputs(st: State) -> None:
    """Nothing of the window is kept: the check reads the warm-up call."""
    return None


def release(st: State) -> None:
    st.algo = None
    gc.collect()


def check(ctx, record: Dict, outputs, fp8: bool = False) -> Dict[str, float]:
    """The numbers compared (``compare``) for round 0's first steps."""
    from reference import server

    ref = server.follow_train(ctx.ref_cfg, ctx.seed, ctx.device,
                              CHECK_STEPS, record["round"], fp8=fp8)
    return compare(record, ref)


def control(ctx, kinds) -> Dict[str, Dict[str, float]]:
    """The numbers of the reference put in the program's place, against
    the float32 reference, for each of ``kinds``: "fp8" (the trunk's and
    BERT's products in float8), or a fault: "half_batch" (each step on half
    its rows) or "unchanged" (no step moves the weights)."""
    from reference import server

    ref = server.follow_train(ctx.ref_cfg, ctx.seed, ctx.device)
    out = {}
    for kind in kinds:
        low = server.follow_train(ctx.ref_cfg, ctx.seed, ctx.device,
                                  fp8=kind == "fp8",
                                  fault=None if kind == "fp8" else kind)
        low["steps"] = low["epoch_steps"]
        out[kind] = compare(low, ref)
    return out


def _running_gaps(prog: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor], kind: str
                  ) -> Dict[str, float]:
    """Per BatchNorm, the gap of what its running ``kind`` ("mean" or
    "var") moved from its start (0, 1) at the first step, as a share of the
    reference's move: ``||p - r|| / ||r - start||``."""
    if set(prog) != set(ref):
        return {"?": float("inf")}
    start = 0.0 if kind == "mean" else 0.9
    return {k: float(torch.linalg.vector_norm(prog[k] - ref[k])
                     / max(float(torch.linalg.vector_norm(ref[k] - start)),
                           1e-30))
            for k in ref if k.endswith("running_" + kind)}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``steps_gap``: the steps the optimizer took in round 0 against the
    epoch's batches, exact; ``loss_gap``: the worst of the first steps'
    relative loss gaps; ``grad_median_gap``: the median leaf's first
    gradient gap by norm (the worst leaf's, an early BatchNorm leaf whose
    batch sum cancels, reads 0.2-0.6 in bf16 and 1e-6 with the port in
    float32: PERF.md); ``change_gap``: the worst moved leaf's change after
    the steps, by norm (leaves whose reference first gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out); ``running_var_gap`` / ``running_mean_gap``: the median
    BatchNorm's move of its running statistics at the first step
    (``_running_gaps``), the trunk's forward alone."""
    from reference import server

    loss_gaps = [abs(p - r) / abs(r)
                 for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = (max(loss_gaps) if len(prog["losses"]) == len(ref["losses"])
                else float("inf"))
    grad_gap, grad_leaf = server.leaf_gap(prog["grads"], ref["grads"])
    change_gap, change_leaf = server.leaf_gap(
        prog["change"], ref["change"], server.moved(ref["grads"]))
    mean_gaps = _running_gaps(prog["running"], ref["running"], "mean")
    var_gaps = _running_gaps(prog["running"], ref["running"], "var")
    diag = {"loss_gaps": loss_gaps, "grad_worst_gap": grad_gap,
            "grad_worst_leaf": grad_leaf,
            "change_median_gap": server.median_gap(prog["change"],
                                                   ref["change"])}
    for name, gaps in (("running_mean", mean_gaps), ("running_var", var_gaps)):
        worst = max(gaps, key=gaps.get)
        diag[name + "_worst_gap"], diag[name + "_worst"] = gaps[worst], worst
    return {"steps_gap": float(abs(prog["steps"] - ref["epoch_steps"])
                               + prog.get("left_over", 0)),
            "loss_gap": loss_gap,
            "grad_median_gap": server.median_gap(prog["grads"],
                                                 ref["grads"]),
            "change_gap": change_gap,
            "running_var_gap": float(np.median(list(var_gaps.values()))),
            "running_mean_gap": float(np.median(list(mean_gaps.values()))),
            "_worst": {"change_gap": change_leaf},
            "_diag": diag}
