"""The server's loss and update in plain PyTorch (frozen copies of the
port's ``losses/mcsoft.py``, ``optim/adamp.py`` and
``optim/factory.py``): the MC soft contrastive loss with one sample and
sum reduction, the model's gradients clipped to a global norm, AdamP with
the round's cosine learning rate."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn


class MCSoft(nn.Module):
    """The PCME criterion's learnable ``shift`` and ``negative_scale`` and
    its loss: pairs ``s = -a sqrt(||x_i - y_j||^2 + eps) + b``, each pair
    ``log(e^s + e^-s) - s m`` (m = +1 matched, -1 not), summed, twice."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.eps = float(cfg["eps"])
        self.shift = nn.Parameter(torch.tensor([float(cfg["init_shift"])]))
        self.negative_scale = nn.Parameter(
            torch.tensor([float(cfg["init_negative_scale"])]))

    def forward(self, img: torch.Tensor, txt: torch.Tensor,
                valid: torch.Tensor = None) -> torch.Tensor:
        """``valid`` [N]: a pair touching a padded row counts nothing."""
        diff = img[:, None, :] - txt[None, :, :]
        dist = torch.sqrt(torch.sum(diff * diff, -1) + self.eps)
        s = -self.negative_scale[0] * dist + self.shift[0]
        n = img.shape[0]
        m = torch.where(torch.eye(n, dtype=torch.bool, device=img.device),
                        1.0, -1.0)
        a = torch.abs(s)
        per_pair = a + torch.log1p(torch.exp(-2.0 * a)) - s * m
        if valid is not None:
            w = valid.float()
            per_pair = per_pair * (w[:, None] * w[None, :])
        return 2.0 * per_pair.sum()


def cosine_lr(base: float, t_max: int, round_n: int) -> float:
    """torch's CosineAnnealingLR stepped per round, evaluated in float32."""
    frac = torch.tensor(round_n, dtype=torch.float32) / t_max
    return float(base * 0.5 * (1.0 + torch.cos(math.pi * frac)))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    logits = logits.float()
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).mean()


@torch.no_grad()
def clip_global(params: List[torch.Tensor], max_norm: float) -> None:
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


def _cos_max(x, y, eps):
    dot = (x * y).sum(1)
    return (dot.abs() / torch.clamp(x.norm(dim=1) * y.norm(dim=1),
                                    min=eps)).max()


class AdamP:
    """AdamP (Heo et al., ICLR 2021): Adam's perturbation, its radial part
    projected out for a parameter of two or more dimensions whose gradient
    is nearly orthogonal to it (channel view, else layer view), weight
    decay decoupled and scaled by ``wd_ratio`` there."""

    def __init__(self, params: List[torch.Tensor], cfg: Dict):
        self.params = params
        self.b1, self.b2 = cfg["betas"]
        self.eps, self.wd = cfg["eps"], cfg["weight_decay"]
        self.delta, self.wd_ratio = cfg["delta"], cfg["wd_ratio"]
        self.state: Dict[int, Dict] = {}
        self.lr = 0.0

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            g = p.grad
            if g is None:  # left out of this step's graph: not stepped
                continue
            st = self.state.setdefault(id(p), {
                "step": 0, "m": torch.zeros_like(p),
                "v": torch.zeros_like(p)})
            st["step"] += 1
            t = st["step"]
            st["m"].mul_(self.b1).add_(g, alpha=1 - self.b1)
            st["v"].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (st["v"] / (1 - self.b2 ** t)).sqrt() + self.eps
            perturb = st["m"] / denom
            wd = 1.0
            if p.dim() > 1:
                rows = p.shape[0]
                for view in ((rows, -1), (1, -1)):
                    pv, gv = p.reshape(view), g.reshape(view)
                    if _cos_max(gv, pv, self.eps) < (
                            self.delta / math.sqrt(pv.shape[1])):
                        pn = pv / (pv.norm(dim=1, keepdim=True) + self.eps)
                        pt = perturb.reshape(view)
                        perturb = (pt - pn * (pn * pt).sum(
                            1, keepdim=True)).reshape(p.shape)
                        wd = self.wd_ratio
                        break
            if self.wd > 0:
                p.mul_(1.0 - self.lr * self.wd * wd)
            p.add_(perturb, alpha=-self.lr / (1 - self.b1 ** t))
