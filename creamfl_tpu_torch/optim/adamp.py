"""AdamP optimizer (Heo et al., ICLR 2021), the server's optimizer.

Port of the JAX package's ``optim/adamp.py``, itself the published
algorithm of the ``adamp`` package the reference uses
(`src/algorithms/optimizers.py:25-29`): Adam moments give the perturbation
``m_hat / (sqrt(v_hat) + eps)``; for a parameter of two or more dimensions
whose gradient is nearly orthogonal to it (max |cos| over the channel view,
else the layer view, below ``delta / sqrt(view size)``), the radial part of
the perturbation is projected out and the decoupled weight decay is scaled
by ``wd_ratio``.

The channel view is ``p.view(p.shape[0], -1)`` for every parameter of two
or more dimensions: conv weights [O, I, kh, kw], linear [out, in] and
embedding tables [vocab, d] alike, which groups exactly as the JAX code's
``channel_axis`` does for Flax's [.., in, out] kernels and [vocab, d]
tables. One-dimensional parameters are never projected.

Each parameter keeps its own step count (``state["step"]``), as the
reference's does. A parameter whose ``.grad`` is None is skipped.

The step counts and the learning rate are float64 tensors on the
parameters' device, and the bias corrections are computed there: a step
reads no host number that changes from step to step, so it can be captured
in a CUDA graph and replayed (``engine/graphs.py``); ``set_learning_rate``
fills the lr tensor in place. The arithmetic is the host-float version's
(float64 corrections, each rounded to float32 where it meets a float32
tensor), bit for bit on the CPU. A state dict of the earlier format (an
int step, a float lr) loads and is converted at the next step.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import torch


def _cosine_max(x: torch.Tensor, y: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """max over rows of |<x_r, y_r>| / max(|x_r| |y_r|, eps)."""
    dot = (x * y).sum(1)
    return (dot.abs() / torch.clamp(x.norm(dim=1) * y.norm(dim=1),
                                    min=eps)).max()


def _project(p: torch.Tensor, g: torch.Tensor, perturb: torch.Tensor,
             delta: float, wd_ratio: float, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-view, else layer-view projection; returns (perturb, wd
    factor as a 0-d tensor). Both projections are computed and one is
    selected on the device, as the JAX code does, so a step never waits
    for the host."""
    rows = p.shape[0]
    pc, gc = p.reshape(rows, -1).float(), g.reshape(rows, -1).float()
    pl, gl = pc.reshape(1, -1), gc.reshape(1, -1)
    use_c = _cosine_max(gc, pc, eps) < delta / math.sqrt(pc.shape[1])
    use_l = ~use_c & (_cosine_max(gl, pl, eps)
                      < delta / math.sqrt(pl.shape[1]))
    pert_c = perturb.reshape(rows, -1)
    pn_c = pc / (pc.norm(dim=1, keepdim=True) + eps)
    proj_c = pert_c - pn_c * (pn_c * pert_c).sum(1, keepdim=True)
    pert_l = perturb.reshape(1, -1)
    pn_l = pl / (pl.norm() + eps)
    proj_l = pert_l - pn_l * (pn_l * pert_l).sum()
    out = torch.where(use_c, proj_c.reshape(p.shape),
                      torch.where(use_l, proj_l.reshape(p.shape), perturb))
    one = torch.ones((), device=p.device)
    return out, torch.where(use_c | use_l, wd_ratio * one, one)


class AdamP(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 delta: float = 0.1, wd_ratio: float = 0.1):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, delta=delta,
                                      wd_ratio=wd_ratio))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params)
        return loss

    @staticmethod
    def _lr(group, device: torch.device) -> torch.Tensor:
        """The group's lr as a float64 tensor on ``device``, made from a
        float once (a new group, or a state dict of the float format)."""
        lr = group["lr"]
        if not isinstance(lr, torch.Tensor):
            lr = group["lr"] = torch.tensor(float(lr), dtype=torch.float64,
                                            device=device)
        return lr

    def _state(self, p: torch.Tensor):
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float64,
                                        device=p.device)
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
        elif not isinstance(state["step"], torch.Tensor):  # an int step
            state["step"] = torch.tensor(float(state["step"]),
                                         dtype=torch.float64,
                                         device=p.device)
        return state

    @torch.no_grad()
    def init_state(self) -> None:
        """Make every parameter's state and every group's lr tensor now
        (zero moments and step: what the first step would make), so that
        a step captured in a CUDA graph allocates none of them."""
        for group in self.param_groups:
            if group["params"]:
                self._lr(group, group["params"][0].device)
            for p in group["params"]:
                self._state(p)

    def _update(self, group, params) -> None:
        """One step over ``params``. The elementwise moments and updates
        run as multi-tensor (foreach) kernels, a few launches for the whole
        list; the projection is per parameter."""
        b1, b2 = group["betas"]
        eps = group["eps"]
        lr = self._lr(group, params[0].device)
        grads = [p.grad for p in params]
        states = [self._state(p) for p in params]
        steps = [st["step"] for st in states]
        torch._foreach_add_(steps, 1.0)
        ms = [st["exp_avg"] for st in states]
        vs = [st["exp_avg_sq"] for st in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        denom = torch._foreach_div(vs, _one_minus_pow(b2, steps))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        perturb = list(torch._foreach_div(ms, denom))
        lr_wd = lr * group["weight_decay"]
        for i, (p, g) in enumerate(zip(params, grads)):
            wd = None  # a float32 0-d tensor where projected
            if p.dim() > 1:
                perturb[i], wd = _project(p, g, perturb[i], group["delta"],
                                          group["wd_ratio"], eps)
            if group["weight_decay"] > 0:
                p.mul_(1.0 - (lr_wd if wd is None else lr_wd.float() * wd))
        torch._foreach_mul_(perturb, torch._foreach_div(
            [torch.neg(lr)] * len(params), _one_minus_pow(b1, steps)))
        torch._foreach_add_(params, perturb)


def _one_minus_pow(beta: float, steps):
    """[1 - beta ** step] as float64 tensors, one a step tensor."""
    out = torch._foreach_pow(beta, steps)
    torch._foreach_neg_(out)
    torch._foreach_add_(out, 1.0)
    return out
