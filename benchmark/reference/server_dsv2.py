"""The server's reference with DeepSeek-V2-Lite as its text tower: a round's
first train steps from the run's seed alone (``reference/server.py``'s
``follow_train`` with the tower's balance loss added to the loss).

The PCME is ``reference.models``' image encoder (ResNet trunk, fc, PIE)
and ``reference.deepseek_v2``'s tower; its weights are drawn from ``seed *
1_000_003`` as the port's ``init_pcme`` draws them for this branch: the
image encoder's (``init_parameters`` over it alone, then the fc and PIE),
then the tower's and its head's. The caption ids are the port's
``SyntheticLMTokenizer`` of each caption's first eight words (a frozen
copy: ``lm_ids``): BOS, each word's id under the seeded map, EOS, padded
with EOS under a zero mask.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

from reference import data, strict_fp32
from reference.deepseek_v2 import (TextEncoderDeepseekV2, init_deepseek_v2,
                                   quantize)
from reference.models import (ImageEncoder, Quant, init_parameters, init_pie,
                              leaves)
from reference.server import _norms, running_stats
from reference.train import AdamP, MCSoft, clip_global, cosine_lr

WORD_TABLE_SIZE, WORD_TABLE_SEED = 1024, 19


class PCME(nn.Module):
    """``fp8``: False (the reference), True (the control: both encoders
    under bf16 autocast, the trunk's and the tower's products in float8)
    or "tower" (the tower's products alone in float8, the trunk in bf16 as
    the program's)."""

    def __init__(self, model_cfg: Dict, fp8=False, fault: str = None):
        super().__init__()
        img, txt = model_cfg["image"], model_cfg["text"]
        self.img_enc = ImageEncoder(img["block"], img["stage_sizes"],
                                    model_cfg["embed_dim"])
        self.txt_enc = TextEncoderDeepseekV2(model_cfg["embed_dim"], txt,
                                             Quant(bool(fp8)), fault)
        quantize(self.img_enc.cnn, Quant(fp8 is True))
        quantize(self.txt_enc.model, Quant(bool(fp8)))
        self.img_enc.low = self.txt_enc.low = bool(fp8)

    def forward(self, images, ids, mask):
        txt, aux = self.txt_enc(ids, mask)
        return self.img_enc(images), txt, aux


def init_pcme(model: PCME, seed: int) -> None:
    """The port's ``init_pcme`` on the DeepSeek-V2 branch, frozen."""
    g = torch.Generator().manual_seed(seed)
    init_parameters(model.img_enc, g)
    nn.init.xavier_uniform_(model.img_enc.fc.weight, generator=g)
    nn.init.zeros_(model.img_enc.fc.bias)
    init_pie(model.img_enc.pie_net, g)
    init_deepseek_v2(model.txt_enc, g)


def lm_ids(cfg: Dict, rows: List[int]):
    """(ids, mask) [B, 32] int64 of public rows ``rows``."""
    txt, d = cfg["model"]["text"], cfg["data"]
    bos, eos = txt["bos_token_id"], txt["eos_token_id"]
    table = np.random.default_rng(WORD_TABLE_SEED).choice(
        bos, size=min(WORD_TABLE_SIZE, bos), replace=False)
    length = data.BERT_MAX_LEN
    ids = np.full((len(rows), length), eos, np.int64)
    mask = np.zeros((len(rows), length), np.int64)
    for i, row in enumerate(rows):
        body = data._caption_body(d["pub_set_seed"], int(row),
                                  d["caption_max_len"])
        words = [str(int(t)) for t in body[:8]][:length - 2]
        seq = [bos] + [int(table[zlib.crc32(w.encode()) % len(table)])
                       for w in words] + [eos]
        ids[i, :len(seq)] = seq
        mask[i, :len(seq)] = 1
    return ids, mask


def batch(cfg: Dict, rows: List[int], device):
    """(images, ids, mask) of public rows ``rows``."""
    d = cfg["data"]
    image_ids = np.asarray(rows, np.int64) // data.CAPTIONS_PER_IMAGE
    if d["images"] == "device":
        imgs = data.images(d["pub_set_seed"], image_ids, d["image_size"],
                           device)
    else:
        imgs = data.host_images(d["pub_set_seed"], image_ids,
                                d["image_size"]).to(device)
    ids, mask = lm_ids(cfg, rows)
    return (imgs, torch.as_tensor(ids, device=device),
            torch.as_tensor(mask, device=device))


def first_captions(cfg: Dict, seed: int, round_n: int = 0):
    """(ids, mask) of the first batch of round ``round_n``'s epoch."""
    d = cfg["data"]
    rows = data.batches(data.epoch_order(d["pub_rows"], seed, round_n),
                        d["batch"])[0]
    return lm_ids(cfg, rows)


def follow_train(cfg: Dict, seed: int, device, steps: int = 3,
                 round_n: int = 0, fp8=False, fault: str = None) -> Dict:
    """``reference.server.follow_train``'s record (the epoch's steps, each
    step's MCSoft loss, every leaf's first gradient after the clip, the
    running statistics after the first step, each leaf's change after the
    last) for this PCME, whose loss adds the tower's balance loss, and the
    tower's embedding of the first batch's captions at the initial weights
    (``embed``). ``fp8``: ``PCME``'s; ``fault``: "no_routed" or
    "held_topk" (``reference.deepseek_v2``)."""
    strict_fp32()
    model = PCME(cfg["model"], fp8=fp8, fault=fault)
    init_pcme(model, seed * 1_000_003)
    model = model.to(device).train()
    crit = MCSoft(cfg["criterion"]).to(device)
    params = leaves(model, crit)
    start = {k: p.detach().clone() for k, p in params.items()}
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
    return {"epoch_steps": len(epoch), "losses": losses, "grads": grads,
            "running": running, "embed": embed,
            "change": _norms({k: p.detach() - start[k]
                              for k, p in params.items()})}
