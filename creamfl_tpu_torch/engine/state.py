"""Train-state container: one model, its optimizer and, for engines with a
learnable criterion, that criterion."""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

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

    def state_dict(self) -> Dict[str, Any]:
        """The model's, criterion's (where there is one) and optimizer's
        state dicts and the step: what a round checkpoint keeps."""
        out = {"model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self.criterion is not None:
            out["criterion"] = self.criterion.state_dict()
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load what ``state_dict`` gave, in place: the optimizer keeps
        its parameters and takes the saved moments and learning rates."""
        self.model.load_state_dict(state["model"])
        if self.criterion is not None:
            self.criterion.load_state_dict(state["criterion"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


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
