"""Unimodal client classification losses.

Reference semantics (``ClientTrainer.py:344-351``):
  * margin-adjusted CE: logits minus ``margin * onehot`` (margin 4)
    before the standard cross-entropy.
  * weight-orthogonality ("center") loss: CE of the Gram matrix
    ``W @ W.T`` ([C, C]) against ``arange(C)``; weighted 0.5 in the total.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax CE with integer labels; ``valid`` ([N] bool/float)
    restricts the mean to real rows of a repeat-padded batch."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[:, None])[:, 0]
    per_row = lse - label_logit
    if valid is None:
        return per_row.mean()
    w = valid.float()
    return torch.sum(per_row * w) / torch.clamp(w.sum(), min=1.0)


def margin_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                        margin: float = 4.0,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """CE over ``logits - margin * onehot(labels)``."""
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return cross_entropy(logits - margin * onehot, labels, valid=valid)


def weight_orthogonality_loss(class_weight: torch.Tensor) -> torch.Tensor:
    """CE(W @ W.T, arange(C)) on the (ReLU-clamped) class weights."""
    c = class_weight.shape[0]
    w = class_weight.float()
    return cross_entropy(w @ w.T, torch.arange(c, device=w.device))
