"""Train-state container: one model and its optimizer."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EngineState:
    """The model holds the params and BatchNorm running stats; the
    optimizer its momentum buffers. Steps update both in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
