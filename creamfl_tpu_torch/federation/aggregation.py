"""con_w representation-ensemble aggregation (reference `MMFL.py:291-335`).

For each client k with public-set representations V_k in R^{N x d} and
the other modality's global features G:
    w_k = diag(log_softmax(V_k @ G.T))          (N-dim, per sample)
    alpha = softmax over clients of [w_1 ... w_K]
    aggregated = sum_k alpha_k * V_k

The diagonal never materialises the N x N logits: on the card it is the
hand-written con_w kernel (``ops.gallery_kernels.conw_diag``), on the CPU
the streamed plain version. One device; the multi-GPU variant comes with
a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from creamfl_tpu_torch.ops import dispatch


def con_w_aggregate(client_reps: torch.Tensor, global_other: torch.Tensor,
                    k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[K, N, d] client reps + [N, d] other-modality globals -> [N, d].

    ``k_mask`` ([K] bool) excludes padded clients from the softmax; their
    diagonals are still computed (as in the JAX package) and then set to
    -inf.
    """
    diag = torch.stack([
        dispatch.conw_diag_log_softmax(client_reps[k], global_other)
        for k in range(client_reps.shape[0])])
    if k_mask is not None:
        diag = diag.masked_fill(~k_mask[:, None], float("-inf"))
    alpha = torch.softmax(diag, dim=0)
    return torch.einsum("kn,knd->nd", alpha, client_reps.float())


def _bucketed(reps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the client axis to the next power of two with zero reps;
    returns (padded reps, k_mask). The JAX package buckets so that one
    compiled program serves every client count of a bucket; the port
    keeps the padding so both compute the same diagonals."""
    k = reps.shape[0]
    bucket = 1 << max(0, (k - 1).bit_length())
    mask = torch.arange(bucket, device=reps.device) < k
    if bucket == k:
        return reps, mask
    pad = reps.new_zeros((bucket - k,) + tuple(reps.shape[1:]))
    return torch.cat([reps, pad]), mask


def aggregate_modalities(img_reps: Optional[torch.Tensor],
                         txt_reps: Optional[torch.Tensor],
                         global_img: torch.Tensor,
                         global_txt: torch.Tensor):
    """Reference ``aggregation()``: image reps weight against the global
    text features and vice versa (MMFL.py:298-331)."""
    img_out = txt_out = None
    if img_reps is not None and len(img_reps) > 0:
        reps, mask = _bucketed(torch.as_tensor(img_reps))
        img_out = con_w_aggregate(reps, global_txt, k_mask=mask)
    if txt_reps is not None and len(txt_reps) > 0:
        reps, mask = _bucketed(torch.as_tensor(txt_reps))
        txt_out = con_w_aggregate(reps, global_img, k_mask=mask)
    return img_out, txt_out
