"""Gallery similarity ops, plain PyTorch: the reference versions of the
hand-written kernels in ``ops.gallery_kernels``.

Three computations hammer a 50 000 x d "gallery" of public-set features:

1. Inter-modal contrastive CE: per public batch, ``CE(f @ G.T / tau, idx)``
   (reference ``ClientTrainer.py:388,493``).
2. con_w aggregation: per client representation matrix ``V`` (50k x d),
   ``diag(log_softmax(V @ G.T))`` (reference ``MMFL.py:304-307``).
3. The CE backward, ``softmax(f @ G.T / tau) @ G``.

The streamed versions never hold more than ``rows x col_block`` logits.
All reductions accumulate in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def streaming_logsumexp(v: torch.Tensor, gallery: torch.Tensor,
                        tau: float = 1.0,
                        col_block: int = 8192) -> torch.Tensor:
    """Row-wise ``logsumexp(v @ gallery.T / tau)`` -> [m] float32, with an
    online (max, sum) carried over gallery blocks of ``col_block`` rows."""
    inv_tau = 1.0 / tau
    v32 = _f32(v)
    run_max = run_sum = None
    for start in range(0, gallery.shape[0], col_block):
        logits = (v32 @ _f32(gallery[start:start + col_block]).T) * inv_tau
        blk_max = logits.max(dim=1).values
        if run_max is None:
            new_max = blk_max
            run_sum = torch.exp(logits - new_max[:, None]).sum(dim=1)
        else:
            new_max = torch.maximum(run_max, blk_max)
            run_sum = (run_sum * torch.exp(run_max - new_max)
                       + torch.exp(logits - new_max[:, None]).sum(dim=1))
        run_max = new_max
    return run_max + torch.log(run_sum)


def gallery_log_softmax_diag(v: torch.Tensor, gallery: torch.Tensor,
                             row_block: int = 1024,
                             col_block: int = 8192) -> torch.Tensor:
    """``diag(log_softmax(v @ gallery.T, dim=1))``, streamed blockwise.

    Reference semantics (``MMFL.py:303-307``): per row
    ``logit_ii - logsumexp_j(logit_ij)`` with no temperature; needs
    ``v.shape[0] == gallery.shape[0]``.
    """
    if v.shape[0] != gallery.shape[0]:
        raise ValueError("con_w needs a square similarity: "
                         f"{v.shape[0]} rows vs {gallery.shape[0]}")
    diag = torch.sum(_f32(v) * _f32(gallery), dim=1)
    lse = torch.cat([
        streaming_logsumexp(v[s:s + row_block], gallery, 1.0, col_block)
        for s in range(0, v.shape[0], row_block)])
    return diag - lse


def softmax_matvec(v: torch.Tensor, gallery: torch.Tensor,
                   lse: torch.Tensor, tau: float = 1.0,
                   col_block: int = 8192) -> torch.Tensor:
    """``softmax(v @ gallery.T / tau) @ gallery`` -> [m, d] float32, given
    the row logsumexp ``lse`` of the same logits."""
    inv_tau = 1.0 / tau
    v32 = _f32(v)
    out = torch.zeros(v.shape[0], gallery.shape[1], dtype=torch.float32,
                      device=v.device)
    for start in range(0, gallery.shape[0], col_block):
        g_blk = _f32(gallery[start:start + col_block])
        probs = torch.exp((v32 @ g_blk.T) * inv_tau - lse[:, None])
        out = out + probs @ g_blk
    return out


def gallery_cross_entropy(feats: torch.Tensor, gallery: torch.Tensor,
                          labels: torch.Tensor, tau: float = 0.5,
                          blockwise: bool = False,
                          col_block: int = 8192) -> torch.Tensor:
    """Mean CE of ``feats @ gallery.T / tau`` against integer ``labels``.

    The gallery is a constant (frozen global features): it gets no
    gradient (``ClientTrainer.py:370,388``). ``blockwise=True`` streams
    the logsumexp over gallery blocks under activation checkpointing, so
    the backward recomputes block logits instead of saving them.
    """
    gallery = gallery.detach()
    labels = labels.long()
    if not blockwise:
        logits = (_f32(feats) @ _f32(gallery).T) / tau
        lse = torch.logsumexp(logits, dim=1)
        label_logit = logits.gather(1, labels[:, None])[:, 0]
        return torch.mean(lse - label_logit)
    label_vecs = gallery.index_select(0, labels)
    label_logit = torch.sum(_f32(feats) * _f32(label_vecs), dim=1) / tau
    lse = torch.utils.checkpoint.checkpoint(
        streaming_logsumexp, feats, gallery, tau, col_block,
        use_reentrant=False)
    return torch.mean(lse - label_logit)
