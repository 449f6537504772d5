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

The step itself is ``ops.adamp.adamp``: on CUDA tensors the multi-tensor
kernel K7 (``csrc/adamp.cu``, three launches for the whole list), on CPU
tensors its plain version (``ops.adamp.adamp_reference``).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from creamfl_tpu_torch.ops.adamp import adamp


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
        """One step over ``params``: ``ops.adamp.adamp``, the multi-tensor
        kernel on CUDA tensors, the plain version on CPU tensors."""
        b1, b2 = group["betas"]
        states = [self._state(p) for p in params]
        adamp(params, [p.grad for p in params],
              [st["exp_avg"] for st in states],
              [st["exp_avg_sq"] for st in states],
              [st["step"] for st in states],
              self._lr(group, params[0].device), beta1=b1, beta2=b2,
              eps=group["eps"], weight_decay=group["weight_decay"],
              delta=group["delta"], wd_ratio=group["wd_ratio"])
