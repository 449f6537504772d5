"""The server's reference: a round's whole train epoch, from the run's
seed alone.

It follows the port's round: the server's weights are drawn from
``seed * 1_000_003`` (``MMFL._init_seed(0)``); round ``n`` seeds torch's
generators with ``seed * 1_000_003 + n`` (``MMFL._seed_round``), which
fixes BERT's dropout masks; the public loader's order in round ``n`` is
``data.epoch_order`` of the run's seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import data, strict_fp32
from reference.models import PCME, init_pcme, leaves
from reference.train import AdamP, MCSoft, clip_global, cosine_lr


def build(cfg: Dict, seed: int, device, fp8: bool = False):
    strict_fp32()
    model = PCME(cfg["model"], fp8=fp8)
    init_pcme(model, seed * 1_000_003)
    crit = MCSoft(cfg["criterion"])
    return model.to(device).train(), crit.to(device)


def batch(cfg: Dict, rows: List[int], device):
    """(images, bert ids, bert mask) of public rows ``rows``."""
    d = cfg["data"]
    cap = data.captions(d["pub_set_seed"], rows, d["caption_max_len"])
    if d["images"] == "device":
        imgs = data.images(d["pub_set_seed"], cap["image_ids"],
                           d["image_size"], device)
    else:
        imgs = data.host_images(d["pub_set_seed"], cap["image_ids"],
                                d["image_size"]).to(device)
    return (imgs, torch.as_tensor(cap["bert_ids"], device=device),
            torch.as_tensor(cap["bert_mask"], device=device))


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.detach().double()))
            for k, t in tensors.items()}


def follow_train(cfg: Dict, seed: int, device, steps: int = 3,
                 round_n: int = 0, fp8: bool = False,
                 fault: str = None) -> Dict:
    """The first ``steps`` train steps of round ``round_n``'s epoch from the
    seed's weights: the epoch's number of steps, each step's loss, every
    leaf's gradient norm as the optimizer takes it at the first step (after
    the clip), every BatchNorm's running statistics after the first step
    (the forward alone has moved them) and every leaf's change after the
    last step. ``fault``, one the check must catch: "half_batch" (each step
    on the first half of its rows) or "unchanged" (no step moves the
    weights)."""
    model, crit = build(cfg, seed, device, fp8)
    params = leaves(model, crit)
    start = {k: p.detach().clone() for k, p in params.items()}
    opt_cfg = cfg["optimizer"]
    opt = AdamP(list(params.values()), opt_cfg)
    opt.lr = cosine_lr(opt_cfg["lr"], opt_cfg["t_max"], round_n)
    if fault == "unchanged":
        opt.lr = 0.0
    d = cfg["data"]
    epoch = data.batches(data.epoch_order(d["pub_rows"], seed, round_n),
                         d["batch"])
    torch.manual_seed(seed * 1_000_003 + round_n)
    losses, grads, running = [], {}, {}
    for t, rows in enumerate(epoch[:steps]):
        if fault == "half_batch":
            rows = rows[:len(rows) // 2]
        images, ids, mask = batch(cfg, rows, device)
        for p in params.values():
            p.grad = None
        img, txt = model(images, ids, mask)
        loss = crit(img, txt)
        loss.backward()
        losses.append(loss.item())
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_global(list(model.parameters()), opt_cfg["grad_clip"])
        if t == 0:
            grads = _norms({k: p.grad for k, p in params.items()})
            running = running_stats(model)
        opt.step()
    return {"epoch_steps": len(epoch), "losses": losses, "grads": grads,
            "running": running,
            "change": _norms({k: p.detach() - start[k]
                              for k, p in params.items()})}


def running_stats(model) -> Dict[str, torch.Tensor]:
    """Every BatchNorm's running mean and variance, by the port's names
    (``model.<buffer>``), in float64 on the host."""
    return {"model." + k: b.detach().double().cpu()
            for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None) -> (float, str):
    """The worst leaf's |‖prog‖ - ‖ref‖| over the larger of its reference
    norm and the median leaf's; (gap, leaf)."""
    if set(prog) != set(ref):
        missing = sorted(set(prog) ^ set(ref))[:4]
        raise KeyError(f"the port's leaves differ from the reference's: "
                       f"{missing}")
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in ref]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved(ref_grads: Dict[str, float]) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(ref_grads.values())))
    return {k for k, v in ref_grads.items() if v >= 1e-3 * med}


def median_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median leaf's |‖prog‖ - ‖ref‖| over the larger of its reference
    norm and the median leaf's (a diagnostic beside ``leaf_gap``)."""
    med = float(np.median(list(ref.values())))
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                            for k in ref]))
