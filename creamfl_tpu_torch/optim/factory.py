"""Optimizers and learning-rate schedules.

Server: AdamP with the learning rate set once per round from a cosine
schedule (T_max 30), after clipping the MODEL's gradients to global norm 2;
the criterion's learnable scalars are left out of the norm
(`retrieval_trainer.py:205-214`; the JAX package's ``make_server_optimizer``).

Unimodal clients: SGD(lr=1e-4, momentum=0.9, wd=5e-5)
with x0.1 decay at 50 % and 80 % of the total rounds
(`ClientTrainer.py:287-302`). The JAX package's
``chain(add_decayed_weights(wd), sgd(lr, momentum))`` is exactly
``torch.optim.SGD(momentum=0.9, weight_decay=wd)``: coupled L2 before
the momentum trace, and a first-step buffer equal to the gradient.

Frozen parameters: torch's optimizers skip every parameter whose
``.grad`` is None, so an unused branch of the forward gets no decay and
no momentum, and its buffer stays as it was. The JAX package emulates
this with ``restore_frozen``; here it holds as long as a step zeroes its
grads with ``set_to_none=True`` and keeps the unused heads out of the
graph.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from creamfl_tpu_torch.optim.adamp import AdamP


def cosine_annealing_schedule(base_lr: float, t_max: int,
                              eta_min: float = 0.0) -> Callable[[int], float]:
    """torch CosineAnnealingLR, stepped per round:
    lr(t) = eta_min + (base - eta_min) (1 + cos(pi t / T_max)) / 2,
    evaluated in fp32 as the JAX package does."""

    def schedule(round_n: int) -> float:
        frac = torch.tensor(round_n, dtype=torch.float32) / t_max
        lr = eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
        return float(lr)

    return schedule


def make_server_optimizer(model_params: Iterable[torch.nn.Parameter],
                          criterion_params: Iterable[torch.nn.Parameter],
                          learning_rate: float, t_max: int = 30,
                          weight_decay: float = 0.0
                          ) -> Tuple[AdamP, Callable[[int], float]]:
    """AdamP over the model's and the criterion's parameters, and the
    cosine schedule ``set_learning_rate`` applies once per round. The clip
    (``clip_grad_global_norm``) is the engine's, on the model's gradients
    only."""
    params = list(model_params) + list(criterion_params)
    opt = AdamP(params, lr=learning_rate, weight_decay=weight_decay)
    return opt, cosine_annealing_schedule(learning_rate, t_max)


@torch.no_grad()
def clip_grad_global_norm(params: Iterable[torch.nn.Parameter],
                          max_norm: float) -> torch.Tensor:
    """Scale the gradients in place to global norm ``max_norm`` when it is
    exceeded, as optax's ``clip_by_global_norm`` (g * max_norm / ||g||;
    ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and gives a
    different step). The choice is made on the device: no host sync.
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def two_step_decay_schedule(init_lr: float, total_rounds: int,
                            decay: float = 0.1) -> Callable[[int], float]:
    """lr * decay at >= 50 % of the rounds, lr * decay^2 at >= 80 %
    (keyed on the round, not the step)."""

    def schedule(round_n: int) -> float:
        if round_n >= 0.8 * total_rounds:
            return init_lr * decay * decay
        if round_n >= 0.5 * total_rounds:
            return init_lr * decay
        return init_lr

    return schedule


def make_client_sgd(params: Iterable[torch.nn.Parameter],
                    init_lr: float = 1e-4, momentum: float = 0.9,
                    weight_decay: float = 5e-5) -> torch.optim.SGD:
    """Client SGD; ``set_learning_rate`` moves it along the round
    schedule (``two_step_decay_schedule``)."""
    return torch.optim.SGD(params, lr=init_lr, momentum=momentum,
                           weight_decay=weight_decay)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's lr; a tensor lr (AdamP's, which a captured CUDA
    graph reads at its address) is filled in place."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
