"""Public-set contrastive regularizers (the CreamFL client losses).

* ``inter_modal_loss``: CE of ``f @ G_other.T / tau`` against the row
  index of each public sample (reference ``ClientTrainer.py:480-504``).
* ``intra_modal_moon_loss``: MOON-style 2-way CE, positive
  ``<f, g_same[idx]>``, negative ``<f, f_old>`` from the frozen pre-round
  model (``ClientTrainer.py:404-414``).

Temperature 0.5 throughout the reference.

A client's contrast step splits in two here: ``ContrastTerms`` (its
forward, up to the feature rows that go into the gallery CE) and
``contrast_loss`` (the combination once those CEs are known), so that a
stacked client family can put all its members' rows through one gallery
CE launch between the two.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from creamfl_tpu_torch.losses.classification import cross_entropy
from creamfl_tpu_torch.ops import gallery_kernels
from creamfl_tpu_torch.ops.gallery import gallery_cross_entropy


def inter_modal_loss(feats: torch.Tensor, global_other: torch.Tensor,
                     batch_index: torch.Tensor, tau: float = 0.5,
                     blockwise: bool = False,
                     segments: int = 1) -> torch.Tensor:
    """CE(f @ G_other.T / tau, batch_index); the gallery is constant.

    Goes to the fused gallery kernel for CUDA tensors; ``blockwise``
    selects the checkpointed streaming plain version. ``segments`` S > 1:
    the rows are S clients' features on one public batch, one after the
    other, and the result is their [S] losses (one kernel launch)."""
    if blockwise:
        return gallery_cross_entropy(feats, global_other, batch_index,
                                     tau=tau, blockwise=True,
                                     segments=segments)
    return gallery_kernels.fused_gallery_ce(feats, global_other, batch_index,
                                            tau, segments=segments)


def intra_modal_moon_loss(feats: torch.Tensor, target_feats: torch.Tensor,
                          old_feats: torch.Tensor,
                          tau: float = 0.5) -> torch.Tensor:
    """2-way CE([pos, neg] / tau, 0) with row-wise dot products; the
    targets and the old model's features are constants."""
    pos = torch.sum(feats * target_feats.detach(), dim=-1).float()
    neg = torch.sum(feats * old_feats.detach(), dim=-1).float()
    logits = torch.stack([pos, neg], dim=1) / tau
    labels = torch.zeros(feats.shape[0], dtype=torch.long,
                         device=feats.device)
    return cross_entropy(logits, labels)


def combine_inter_intra(loss_intra: torch.Tensor, loss_inter: torch.Tensor,
                        interintra_weight: float = 0.5,
                        loss_scale: bool = False) -> torch.Tensor:
    """Reference combination (``ClientTrainer.py:416-419``): plain sum,
    or ratio-normalised with ``--loss_scale``."""
    if loss_scale:
        ratio = (loss_inter / loss_intra).detach()
        return (loss_intra + loss_inter / ratio) * interintra_weight
    return (loss_intra + loss_inter) * interintra_weight


@dataclasses.dataclass
class ContrastTerms:
    """One client's contrast step before its inter-modal CEs: ``inter``
    holds (feature rows, gallery) per gallery CE (one for a unimodal
    client, two for mm), ``index`` the batch's rows in the public set
    (the CEs' labels); the intra term as ``intra`` (mm), or as the
    (feats, targets, old feats) of ``intra_modal_moon_loss`` in ``moon``
    (unimodal clients form it after the CEs, see
    ``UniClientEngine.contrast_loss``), or neither."""

    inter: List[Tuple[torch.Tensor, torch.Tensor]]
    index: torch.Tensor
    intra: Optional[torch.Tensor] = None
    moon: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def contrast_loss(inter_losses: Sequence[torch.Tensor],
                  intra: Optional[torch.Tensor],
                  interintra_weight: float = 0.5,
                  loss_scale: bool = False) -> torch.Tensor:
    """A client's contrast loss from its gallery CEs (summed in order) and
    its intra term: both combined as ``combine_inter_intra`` does, or the
    one that is there."""
    inter = None
    for loss in inter_losses:
        inter = loss if inter is None else inter + loss
    if inter is not None and intra is not None:
        return combine_inter_intra(intra, inter, interintra_weight,
                                   loss_scale)
    if inter is None and intra is None:
        raise ValueError("a contrast step needs do_inter or do_intra")
    return intra if inter is None else inter
