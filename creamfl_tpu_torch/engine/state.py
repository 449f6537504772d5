"""Train-state container: one model, its optimizer and, for engines with a
learnable criterion, that criterion."""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class EngineState:
    """The model holds the params and BatchNorm running stats; the
    criterion (the server's PCME shift and negative_scale) its learnable
    scalars; the optimizer the moments of both. Steps update all of them
    in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    criterion: Optional[torch.nn.Module] = None


def frozen_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A frozen copy of ``model`` in eval mode: the pre-round model of the
    clients' intra term (the reference deep-copies the model at round
    start, ClientTrainer.py:195). RNN weights are re-packed into one buffer
    after the copy, as cuDNN wants them."""
    old = copy.deepcopy(model).eval()
    old.requires_grad_(False)
    for m in old.modules():
        if isinstance(m, torch.nn.RNNBase):
            m.flatten_parameters()
    return old
