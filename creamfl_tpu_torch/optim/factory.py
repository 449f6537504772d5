"""Client optimizer and learning-rate schedule.

Parity target (unimodal clients): SGD(lr=1e-4, momentum=0.9, wd=5e-5)
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

from typing import Callable, Iterable

import torch


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
    for group in opt.param_groups:
        group["lr"] = lr
