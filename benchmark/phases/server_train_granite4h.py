"""Phase: the server's train epoch, ``MMFL._server_train_epoch()``, with
Granite-4.0-H-Small as the server's text tower.

The set-up, the warm-up, the call and the operation count are
``server_train_dsv2``'s (that phase's module, loaded by name, which loads
``server_train``'s): round ``n``'s seeding and learning rate, then one
epoch over the public loader on the round's own method, with the
program's recorder on, its held experts' work counted from the pairs the
program tallied (``moe.held_pairs``), and the tower run once in set-up on
round 0's first captions at the initial weights. The check follows the
same first three steps with this configuration's reference
(``reference/server_granite.py``) and compares what ``server_train``
compares, the tower's embedding (``text_embed_gap``), the median gap of
the first gradients of the held experts' leaves
(``expert_grad_median_gap``) and of the routers' (``router_grad_median_gap``),
and for the Mamba mixers' own leaves (``A_log``, ``dt_bias``, ``D``, the
conv's weight and bias, the gated norm's weight) the largest of each kind's
median gap over the mixers (``ssm_grad_median_gap``): a fault in one kind,
such as the step size's bias left out, moves that kind's gradients alone,
which a median over all of them would not show.

``traced_call``, the profiled call: ``bench.ssm`` ranges around each Mamba
mixer, opened and closed by module hooks that exist for this call alone.
In the forward one range spans each mixer; in the backward the mixer's
parts (``out_proj``, the gated norm, the scan, the conv, ``in_proj``) and
the gaps between them each get one, one after the other, so that the
trace's reduction, which looks back over a few dozen ranges of a thread
for the open ones, finds it from every kernel. ``trace_facts`` hands over
the recording's counters (``mamba.tokens``, ``moe.held_pairs``, ...) and
its span seconds.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from benchlib import registry

_DSV2 = registry.load_module(
    "phases", "server_train_dsv2",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BASE = _DSV2._BASE

CHECK_STEPS = _DSV2.CHECK_STEPS
SSM_RANGE = "bench.ssm"
# The mixer's parts, in the order their backward runs.
_PARTS = ("out_proj", "norm", "scan", "conv1d", "in_proj")
_SSM_KINDS = ("A_log", "dt_bias", ".D", "conv1d.weight", "conv1d.bias",
              "mamba.norm.weight")

setup = _DSV2.setup
call = _DSV2.call
warm = _DSV2.warm
flops = _DSV2.flops
steps_so_far = _DSV2.steps_so_far
failed = _DSV2.failed
outputs = _DSV2.outputs
release = _DSV2.release


# -- the profiled call ---------------------------------------------------
def mixers(model):
    """The tower's Mamba mixers: modules with the children ``_PARTS`` and
    an ``A_log`` (none in a program without the tower)."""
    return [m for m in model.modules()
            if hasattr(m, "A_log") and all(hasattr(m, p) for p in _PARTS)]


def range_hooks(model):
    """Hooks that open ``bench.ssm`` around each mixer's forward and tile
    its backward with ranges that close and open at each part's backward
    hooks; returns their handles."""
    ranges, handles = _DSV2._Ranges(), []

    def opener(key):
        def hook(module, *args):
            ranges.enter(key, SSM_RANGE)
        return hook

    def closer(key):
        def hook(module, *args):
            ranges.exit(key)
        return hook

    def turner(key):
        def hook(module, *args):
            ranges.exit(key)
            ranges.enter(key, SSM_RANGE)
        return hook

    for mixer in mixers(model):
        key = id(mixer)
        handles += [mixer.register_forward_pre_hook(opener(key)),
                    mixer.register_forward_hook(closer(key)),
                    mixer.register_full_backward_pre_hook(opener(key)),
                    mixer.register_full_backward_hook(closer(key))]
        for name in _PARTS:
            part = getattr(mixer, name)
            handles += [part.register_full_backward_pre_hook(turner(key)),
                        part.register_full_backward_hook(turner(key))]
    return handles


def traced_call(st, n: int) -> Dict:
    handles = range_hooks(st.algo.server_state.model)
    try:
        return call(st, n)
    finally:
        for h in handles:
            h.remove()


def trace_facts(st) -> Dict:
    """The recording's counters and span seconds (``program``)."""
    snap = getattr(st, "snapshot", None)
    if snap is None:
        return {}
    return {"program": {"counters": dict(snap.counters),
                        "seconds": dict(snap.seconds)}}


# -- the check -----------------------------------------------------------
def _leaf_groups(names):
    experts = [k for k in names if ".block_sparse_moe.experts." in k]
    routers = [k for k in names
               if k.endswith(".block_sparse_moe.router.layer.weight")]
    return {"expert": experts, "router": routers}


def _ssm_kinds(names):
    return {kind: [k for k in names if ".mamba." in k and k.endswith(kind)]
            for kind in _SSM_KINDS}


def check(ctx, record: Dict, outputs) -> Dict[str, float]:
    """The numbers compared (``compare``) for round 0's first steps."""
    from reference import server_granite

    ref = server_granite.follow_train(ctx.ref_cfg, ctx.seed, ctx.device,
                                      CHECK_STEPS, record["round"])
    return compare(record, ref)


def control(ctx, kinds) -> Dict[str, Dict[str, float]]:
    """The numbers of the reference put in the program's place, against
    the float32 reference, for each of ``kinds``: "fp8" (the trunk's and
    the tower's products in float8), "fp8_tower" (the tower's alone, the
    trunk in bf16), "bf16_scan" (the program's precision with the scan's
    state and products in bfloat16), or a fault: "dt_unbiased" (``dt_bias``
    left out of the step size) or "norm_ungated" (the ``silu(z)`` gate left
    out of the mixer's norm)."""
    from reference import server_granite

    precision = ("fp8", "fp8_tower", "bf16_scan")
    ref = server_granite.follow_train(ctx.ref_cfg, ctx.seed, ctx.device)
    out = {}
    for kind in kinds:
        low = server_granite.follow_train(
            ctx.ref_cfg, ctx.seed, ctx.device,
            low=kind if kind in precision else False,
            fault=None if kind in precision else kind)
        low["steps"] = low["epoch_steps"]
        out[kind] = compare(low, ref)
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``server_train``'s numbers; ``text_embed_gap``: the tower's
    embedding of the first captions at the initial weights, ``||p - r|| /
    ||r||`` over the batch; ``expert_grad_median_gap``,
    ``router_grad_median_gap``: the median leaf's first gradient gap by
    norm in each group, over the larger of its reference norm and its
    group's median (``reference.server.median_gap``);
    ``ssm_grad_median_gap``: the largest of that median over each kind of
    the mixers' own leaves."""
    from reference import server

    out = _BASE.compare(prog, ref)
    p, r = prog.get("embed"), ref["embed"]
    out["text_embed_gap"] = (
        float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))
        if p is not None and p.shape == r.shape else float("inf"))
    for name, keys in _leaf_groups(ref["grads"]).items():
        if not keys:
            out[f"{name}_grad_median_gap"] = float("inf")
            continue
        mine = {k: prog["grads"].get(k, float("inf")) for k in keys}
        theirs = {k: ref["grads"][k] for k in keys}
        out[f"{name}_grad_median_gap"] = server.median_gap(mine, theirs)
        worst, leaf = server.leaf_gap(mine, theirs)
        out["_diag"][f"{name}_grad_worst_gap"] = worst
        out["_diag"][f"{name}_grad_worst_leaf"] = leaf
    kinds = {kind: server.median_gap(
        {k: prog["grads"].get(k, float("inf")) for k in keys},
        {k: ref["grads"][k] for k in keys})
        for kind, keys in _ssm_kinds(ref["grads"]).items() if keys}
    out["ssm_grad_median_gap"] = (max(kinds.values()) if kinds
                                  else float("inf"))
    out["_diag"]["ssm_grad_median_gap_by_kind"] = kinds
    return out
