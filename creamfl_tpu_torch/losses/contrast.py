"""Public-set contrastive regularizers (the CreamFL client losses).

* ``inter_modal_loss``: CE of ``f @ G_other.T / tau`` against the row
  index of each public sample (reference ``ClientTrainer.py:480-504``).
* ``intra_modal_moon_loss``: MOON-style 2-way CE, positive
  ``<f, g_same[idx]>``, negative ``<f, f_old>`` from the frozen pre-round
  model (``ClientTrainer.py:404-414``).

Temperature 0.5 throughout the reference.
"""

from __future__ import annotations

import torch

from creamfl_tpu_torch.losses.classification import cross_entropy
from creamfl_tpu_torch.ops import dispatch
from creamfl_tpu_torch.ops.gallery import gallery_cross_entropy


def inter_modal_loss(feats: torch.Tensor, global_other: torch.Tensor,
                     batch_index: torch.Tensor, tau: float = 0.5,
                     blockwise: bool = False) -> torch.Tensor:
    """CE(f @ G_other.T / tau, batch_index); the gallery is constant.

    Goes to the fused gallery kernel for CUDA tensors; ``blockwise``
    selects the checkpointed streaming plain version."""
    if blockwise:
        return gallery_cross_entropy(feats, global_other, batch_index,
                                     tau=tau, blockwise=True)
    return dispatch.gallery_ce(feats, global_other, batch_index, tau)


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
