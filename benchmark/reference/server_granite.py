"""The server's reference with Granite-4.0-H-Small as its text tower: a
round's first train steps from the run's seed alone
(``reference/server_dsv2.py``'s ``follow_train`` with this tower).

The PCME is ``reference.models``' image encoder (ResNet trunk, fc, PIE)
and ``reference.granite_h``'s tower; its weights are drawn from ``seed *
1_000_003`` as the port's ``init_pcme`` draws them for a decoder tower:
the image encoder's (``init_parameters`` over it alone, then the fc and
PIE), then the tower's and its head's. The caption ids are
``server_dsv2.lm_ids`` with this configuration's BOS and EOS.

Each leaf's starting value is kept on the host, not beside the model: the
tower's 2.4 B weights, their gradients and AdamP's moments take half the
card already.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from reference import data, strict_fp32
from reference.deepseek_v2 import quantize
from reference.granite_h import TextEncoderGraniteH, init_granite_h
from reference.models import (ImageEncoder, Quant, init_parameters, init_pie,
                              leaves)
from reference.server import _norms, running_stats
from reference.server_dsv2 import batch
from reference.train import AdamP, MCSoft, clip_global, cosine_lr


class PCME(nn.Module):
    """``low``: False (the reference), "fp8" (the control: both encoders
    under bf16 autocast, the trunk's and the tower's products in float8),
    "fp8_tower" (the tower's products alone in float8, the trunk in bf16 as
    the program's) or "bf16_scan" (both encoders under bf16 autocast as the
    program's, and the tower's scan in bfloat16)."""

    def __init__(self, model_cfg: Dict, low=False, fault: str = None):
        super().__init__()
        img, txt = model_cfg["image"], model_cfg["text"]
        self.img_enc = ImageEncoder(img["block"], img["stage_sizes"],
                                    model_cfg["embed_dim"])
        tower8 = low in ("fp8", "fp8_tower")
        self.txt_enc = TextEncoderGraniteH(
            model_cfg["embed_dim"], txt, Quant(tower8), fault,
            scan="bf16" if low == "bf16_scan" else "fp32")
        quantize(self.img_enc.cnn, Quant(low == "fp8"))
        quantize(self.txt_enc.model, Quant(tower8))
        self.img_enc.low = self.txt_enc.low = bool(low)

    def forward(self, images, ids, mask):
        txt, aux = self.txt_enc(ids, mask)
        return self.img_enc(images), txt, aux


def init_pcme(model: PCME, seed: int) -> None:
    """The port's ``init_pcme`` on a decoder tower's branch, frozen."""
    g = torch.Generator().manual_seed(seed)
    init_parameters(model.img_enc, g)
    nn.init.xavier_uniform_(model.img_enc.fc.weight, generator=g)
    nn.init.zeros_(model.img_enc.fc.bias)
    init_pie(model.img_enc.pie_net, g)
    init_granite_h(model.txt_enc, g,
                   model.txt_enc.model.cfg["initializer_range"])


def follow_train(cfg: Dict, seed: int, device, steps: int = 3,
                 round_n: int = 0, low=False, fault: str = None) -> Dict:
    """``reference.server.follow_train``'s record (the epoch's steps, each
    step's MCSoft loss, every leaf's first gradient after the clip, the
    running statistics after the first step, each leaf's change after the
    last) for this PCME, whose loss adds the tower's balance loss, and the
    tower's embedding of the first batch's captions at the initial weights
    (``embed``). ``low``: ``PCME``'s; ``fault``: "dt_unbiased" or
    "norm_ungated" (``reference.granite_h``)."""
    strict_fp32()
    model = PCME(cfg["model"], low=low, fault=fault)
    init_pcme(model, seed * 1_000_003)
    model = model.to(device).train()
    crit = MCSoft(cfg["criterion"]).to(device)
    params = leaves(model, crit)
    start = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    opt_cfg = cfg["optimizer"]
    opt = AdamP(list(params.values()), opt_cfg)
    opt.lr = cosine_lr(opt_cfg["lr"], opt_cfg["t_max"], round_n)
    d = cfg["data"]
    epoch = data.batches(data.epoch_order(d["pub_rows"], seed, round_n),
                         d["batch"])
    torch.manual_seed(seed * 1_000_003 + round_n)
    losses, grads, running, embed = [], {}, {}, None
    for t, rows in enumerate(epoch[:steps]):
        images, ids, mask = batch(cfg, rows, device)
        for p in params.values():
            p.grad = None
        img, txt, aux = model(images, ids, mask)
        loss = crit(img, txt)
        losses.append(loss.item())
        (loss + aux).backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_global(list(model.parameters()), opt_cfg["grad_clip"])
        if t == 0:
            grads = _norms({k: p.grad for k, p in params.items()})
            running = running_stats(model)
            embed = txt.detach().float().cpu()
        opt.step()
    change = {k: float(torch.linalg.vector_norm(
        p.detach().double() - start[k].to(p.device).double()))
        for k, p in params.items()}
    return {"epoch_steps": len(epoch), "losses": losses, "grads": grads,
            "running": running, "embed": embed, "change": change}
