"""Phase: the server's train epoch, ``MMFL._server_train_epoch()``, with
DeepSeek-V2-Lite as the server's text tower.

The call, the set-up and the warm-up are ``server_train``'s (that phase's
module, loaded by name), with what is said below added: round ``n``'s
seeding and learning rate, then one epoch over the public loader, on the
round's own method. The check follows the same first three steps with the
reference of this configuration (``reference/server_dsv2.py``) and
compares what ``server_train`` compares, plus the median gap of the first
gradients of the held experts' leaves (``expert_grad_median_gap``) and of
the routers' (``router_grad_median_gap``).

``traced_call``, the profiled call: the program's recorder on
(``utils/profiling.recording()``, looked up by name: a program without it
records nothing), and ``bench.moe`` / ``bench.moe.experts`` ranges around
the tower's MoE layers and their held experts, opened and closed by module
hooks that exist for this call alone. In the forward one ``bench.moe``
range spans each MoE layer; in the backward one spans each of the layer's
parts (router, held experts, combination, shared experts), so that the
trace's reduction, which looks back over a few dozen ranges of a thread
for the open ones, finds it from every kernel. ``trace_facts`` hands over
the recording's counters (``moe.held_pairs``, ``moe.tokens``,
``moe.pairs``) and its span seconds.

Every call runs with the recorder on, so that ``flops`` counts the held
experts' work from the pairs they computed in the window (the device
tally ``moe.held_pairs``, read once a call when the recording closes), not
from an even share of the routing: the routing drifts as the server
trains. The recorder costs the window a few microseconds a span (about
two thousand spans a call).

Set-up also runs the program's tower once, before round 0's first step,
on that step's captions at the initial weights (``warm``): the check
compares its embedding with the reference's (``text_embed_gap``), the one
number that reads the tower's forward alone.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from benchlib import registry

_BASE = registry.load_module(
    "phases", "server_train",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHECK_STEPS = _BASE.CHECK_STEPS
MOE_RANGE, EXPERTS_RANGE = "bench.moe", "bench.moe.experts"

steps_so_far = _BASE.steps_so_far
failed = _BASE.failed
outputs = _BASE.outputs
release = _BASE.release


def setup(ctx):
    st = _BASE.setup(ctx)
    st.pair_flops = 3 * ctx.flops.pair_forward(ctx.model_cfg["text"])
    st.held_pairs, st.snapshot = 0, None
    return st


def call(st, n: int) -> Dict:
    """``server_train``'s call with the program's recorder on (where the
    program has one); adds the held pairs it counted to ``held_pairs``."""
    from creamfl_tpu_torch.utils import profiling

    recording = getattr(profiling, "recording", None)
    if recording is None:
        st.snapshot = None
        return _BASE.call(st, n)
    with recording() as snap:
        out = _BASE.call(st, n)
    st.snapshot = snap
    st.held_pairs += snap.counters.get("moe.held_pairs", 0)
    return out


def flops(st, steps: int) -> float:
    """The model operations of ``steps`` train steps of a full batch: the
    configuration's count a sample, which leaves the held experts out,
    plus a held expert's forward and backward for each pair the program
    tallied in the calls so far (the window's)."""
    return steps * st.batch * st.per_sample + st.held_pairs * st.pair_flops


def tower_embedding(st) -> torch.Tensor:
    """The program's tower on the captions of round 0's first batch, at
    the weights it holds (float32 [B, E], on the host)."""
    from reference import server_dsv2

    ids, mask = server_dsv2.first_captions(st.ctx.ref_cfg, st.ctx.seed)
    dev = st.ctx.device
    with torch.no_grad():
        out = st.algo.server_state.model.txt_enc(
            torch.as_tensor(ids, device=dev),
            torch.as_tensor(mask, device=dev))
    return out["embedding"].float().cpu()


def warm(st) -> Dict:
    """``server_train``'s warm-up, after the tower's embedding of round
    0's first captions at the initial weights (``embed``)."""
    embed = tower_embedding(st)
    record = _BASE.warm(st)
    record["embed"] = embed
    return record


# -- the profiled call ---------------------------------------------------
class _Ranges:
    """``record_function`` ranges opened by one hook and closed by another
    (a stack per module: a module's ranges nest)."""

    def __init__(self):
        self.open: Dict[int, list] = {}

    def enter(self, key: int, name: str) -> None:
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        self.open.setdefault(key, []).append(rf)

    def exit(self, key: int) -> None:
        self.open[key].pop().__exit__(None, None, None)


def moe_layers(model):
    """The tower's MoE layers: modules with ``gate``, ``experts`` and
    ``shared_experts`` children (none in a program without the tower)."""
    return [m for m in model.modules()
            if all(hasattr(m, c) for c in ("gate", "experts",
                                           "shared_experts"))]


def range_hooks(model):
    """Hooks that open ``bench.moe`` around each MoE layer's forward and
    each of its parts' backward, and ``bench.moe.experts`` around the held
    experts' forward and backward; returns their handles."""
    ranges, handles = _Ranges(), []

    def opener(*names):
        def hook(module, *args):
            for n in names:
                ranges.enter(id(module), n)
        return hook

    def closer(count):
        def hook(module, *args):
            for _ in range(count):
                ranges.exit(id(module))
        return hook

    for layer in moe_layers(model):
        handles += [layer.register_forward_pre_hook(opener(MOE_RANGE)),
                    layer.register_forward_hook(closer(1))]
        ex = layer.experts
        handles += [ex.register_forward_pre_hook(opener(EXPERTS_RANGE)),
                    ex.register_forward_hook(closer(1))]
        for part in (layer.gate, layer.experts, layer.shared_experts,
                     getattr(layer, "combine", None)):
            if part is None:
                continue
            names = ((MOE_RANGE, EXPERTS_RANGE) if part is ex
                     else (MOE_RANGE,))
            handles += [
                part.register_full_backward_pre_hook(opener(*names)),
                part.register_full_backward_hook(closer(len(names)))]
    return handles


def traced_call(st, n: int) -> Dict:
    handles = range_hooks(st.algo.server_state.model)
    try:
        return call(st, n)
    finally:
        for h in handles:
            h.remove()


def trace_facts(st) -> Dict:
    """The recording's counters and span seconds (``program``), and the
    held experts' (hidden, width) (``expert_shape``)."""
    snap = getattr(st, "snapshot", None)
    if snap is None:
        return {}
    text = st.ctx.model_cfg["text"]
    return {"program": {"counters": dict(snap.counters),
                        "seconds": dict(snap.seconds)},
            "expert_shape": (text["hidden_size"],
                             text["moe_intermediate_size"])}


# -- the check -----------------------------------------------------------
def _leaf_groups(names):
    experts = [k for k in names if ".mlp.experts." in k]
    routers = [k for k in names if k.endswith(".mlp.gate.weight")]
    return experts, routers


def check(ctx, record: Dict, outputs, fp8: bool = False) -> Dict[str, float]:
    """The numbers compared (``compare``) for round 0's first steps."""
    from reference import server_dsv2

    ref = server_dsv2.follow_train(ctx.ref_cfg, ctx.seed, ctx.device,
                                   CHECK_STEPS, record["round"], fp8=fp8)
    return compare(record, ref)


def control(ctx, kinds) -> Dict[str, Dict[str, float]]:
    """The numbers of the reference put in the program's place, against
    the float32 reference, for each of ``kinds``: "fp8" (the trunk's and
    the tower's products in float8), "fp8_tower" (the tower's alone, the
    trunk in bf16), or a fault: "no_routed" (the routed experts' output
    left out) or "held_topk" (the top-k over the held experts only)."""
    from reference import server_dsv2

    precision = {"fp8": True, "fp8_tower": "tower"}
    ref = server_dsv2.follow_train(ctx.ref_cfg, ctx.seed, ctx.device)
    out = {}
    for kind in kinds:
        low = server_dsv2.follow_train(
            ctx.ref_cfg, ctx.seed, ctx.device, fp8=precision.get(kind, False),
            fault=None if kind in precision else kind)
        low["steps"] = low["epoch_steps"]
        out[kind] = compare(low, ref)
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``server_train``'s numbers; ``expert_grad_median_gap`` /
    ``router_grad_median_gap``: the median held-expert leaf's (router
    leaf's) first gradient gap by norm, each over the larger of its
    reference norm and its group's median (``reference.server
    .median_gap``); ``text_embed_gap``: the tower's embedding of the first
    captions at the initial weights, ``||p - r|| / ||r||`` over the
    batch."""
    from reference import server

    out = _BASE.compare(prog, ref)
    p, r = prog.get("embed"), ref["embed"]
    out["text_embed_gap"] = (
        float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))
        if p is not None and p.shape == r.shape else float("inf"))
    experts, routers = _leaf_groups(ref["grads"])
    for name, keys in (("expert", experts), ("router", routers)):
        if not keys:
            out[f"{name}_grad_median_gap"] = float("inf")
            continue
        mine = {k: prog["grads"].get(k, float("inf")) for k in keys}
        theirs = {k: ref["grads"][k] for k in keys}
        out[f"{name}_grad_median_gap"] = server.median_gap(mine, theirs)
        worst, leaf = server.leaf_gap(mine, theirs)
        out["_diag"][f"{name}_grad_worst_gap"] = worst
        out["_diag"][f"{name}_grad_worst_leaf"] = leaf
    out["_diag"]["expert_grad_ref_median"] = float(
        np.median([ref["grads"][k] for k in experts])) if experts else 0.0
    return out
