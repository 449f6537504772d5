"""Classification-loss factory (reference `src/losses/__init__.py`).

Port of the JAX package's ``losses/factory.py``. The reference registers a
dozen metric-learning losses, of which only ``softmax`` (plain CE) is ever
used by CreamFL (default ``loss='softmax'`` at ClientTrainer.py:137). The
live one is here plus the two simple legacy ones (triplet, center); the
remaining legacy names raise ``NotImplementedError``, as in the JAX
package (they are dead code in the reference pipeline), and unknown names
raise ``ValueError``.
"""

from __future__ import annotations

from typing import Callable

import torch

from creamfl_tpu_torch.losses.classification import cross_entropy

_LEGACY_DEAD = ("batchall", "batchhard", "neighbour", "nhard",
                "histogram", "distance_match", "gaussian_metric",
                "center_triplet")


def triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                 margin: float = 1.0) -> torch.Tensor:
    """Batch-hard triplet loss on L2 distances."""
    sq = torch.sum(embeddings ** 2, 1)
    d = torch.sqrt(torch.clamp(sq[:, None] - 2 * embeddings @ embeddings.T
                               + sq[None, :], min=0.0) + 1e-12)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(labels), dtype=torch.bool, device=labels.device)
    zero = d.new_zeros(())
    pos = torch.amax(torch.where(same & ~eye, d, zero), dim=1)
    neg = torch.amin(torch.where(~same, d, d.new_full((), float("inf"))),
                     dim=1)
    neg = torch.where(torch.isinf(neg), zero, neg)
    return torch.mean(torch.clamp(pos - neg + margin, min=0.0))


def center_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                centers: torch.Tensor) -> torch.Tensor:
    """Mean squared distance to class centers."""
    c = centers[labels.long()]
    return torch.mean(torch.sum((embeddings - c) ** 2, dim=1))


def create(name: str = "softmax") -> Callable:
    name = name.lower()
    if name == "softmax":
        return cross_entropy
    if name == "triplet":
        return triplet_loss
    if name == "center":
        return center_loss
    if name in _LEGACY_DEAD:
        raise NotImplementedError(
            f"loss {name!r} is legacy dead code in the reference "
            f"(never reached by CreamFL); use 'softmax'")
    raise ValueError(f"unknown loss {name!r}")
