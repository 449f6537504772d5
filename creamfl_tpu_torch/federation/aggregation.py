"""con_w representation-ensemble aggregation (reference `MMFL.py:291-335`).

For each client k with public-set representations V_k in R^{N x d} and
the other modality's global features G:
    w_k = diag(log_softmax(V_k @ G.T))          (N-dim, per sample)
    alpha = softmax over clients of [w_1 ... w_K]
    aggregated = sum_k alpha_k * V_k

The diagonal never materialises the N x N logits: on the card it is the
hand-written con_w kernel (``ops.gallery_kernels.conw_diag``), on the CPU
the streamed plain version.

On a mesh of ranks (``mesh``) the uploads stay on the rank that trained
their client: ``client_reps`` is then the list of the K slots with this
rank's uploads in theirs and None in the others'. Each rank runs the
diagonal on its own uploads, the [K, N] diagonals are summed over the ranks
(each row comes from one rank: an all-gather), every rank takes the
softmax over clients, and the sum of alpha_k V_k over each rank's own
clients is summed over the ranks: the JAX package's shard_map over the
``client`` axis and its psum-weighted reduction. A masked (pad) slot's
diagonal is -inf whatever it holds, so the mesh skips its kernel launch;
the output is the single-device ``_bucketed`` path's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from creamfl_tpu_torch.ops import dispatch
from creamfl_tpu_torch.parallel import mesh as M

Reps = Union[torch.Tensor, Sequence[Optional[torch.Tensor]]]


def con_w_aggregate(client_reps: Reps, global_other: torch.Tensor,
                    k_mask: Optional[torch.Tensor] = None,
                    mesh: Optional[M.Mesh] = None) -> torch.Tensor:
    """[K, N, d] client reps + [N, d] other-modality globals -> [N, d].

    ``k_mask`` ([K] bool) excludes padded clients from the softmax; off a
    mesh their diagonals are still computed (as in the JAX package) and
    then set to -inf. ``mesh``: ``client_reps`` holds this rank's uploads
    and None for the others' (the module docstring).
    """
    if M.active(mesh):
        return _con_w_mesh(client_reps, global_other, k_mask, mesh)
    diag = torch.stack([
        dispatch.conw_diag_log_softmax(client_reps[k], global_other)
        for k in range(len(client_reps))])
    if k_mask is not None:
        diag = diag.masked_fill(~k_mask[:, None], float("-inf"))
    alpha = torch.softmax(diag, dim=0)
    return torch.einsum("kn,knd->nd", alpha,
                        torch.as_tensor(client_reps).float())


def _con_w_mesh(client_reps, global_other, k_mask, mesh) -> torch.Tensor:
    k, (n, d) = len(client_reps), global_other.shape
    dev = global_other.device
    if k_mask is None:
        k_mask = torch.ones(k, dtype=torch.bool)
    keep = k_mask.tolist()
    mine = [i for i, r in enumerate(client_reps)
            if r is not None and keep[i]]
    diag = torch.zeros((k, n), dtype=torch.float32, device=dev)
    for i in mine:
        diag[i] = dispatch.conw_diag_log_softmax(client_reps[i],
                                                 global_other)
    M.all_reduce_sum(mesh, diag)
    diag = diag.masked_fill(~k_mask.to(dev)[:, None], float("-inf"))
    alpha = torch.softmax(diag, dim=0)
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    for i in mine:
        out += alpha[i][:, None] * client_reps[i].float()
    return M.all_reduce_sum(mesh, out)


def _bucketed(reps: Reps) -> Tuple[Reps, torch.Tensor]:
    """Pad the client axis to the next power of two with zero reps (None
    slots in a list); returns (padded reps, k_mask). The JAX package
    buckets so that one compiled program serves every client count of a
    bucket; the port keeps the padding so both compute the same
    diagonals."""
    k = len(reps)
    bucket = 1 << max(0, (k - 1).bit_length())
    mask = torch.arange(bucket) < k
    if isinstance(reps, torch.Tensor):
        mask = mask.to(reps.device)
        if bucket == k:
            return reps, mask
        pad = reps.new_zeros((bucket - k,) + tuple(reps.shape[1:]))
        return torch.cat([reps, pad]), mask
    return list(reps) + [None] * (bucket - k), mask


def aggregate_modalities(img_reps: Optional[Reps],
                         txt_reps: Optional[Reps],
                         global_img: torch.Tensor,
                         global_txt: torch.Tensor,
                         mesh: Optional[M.Mesh] = None):
    """Reference ``aggregation()``: image reps weight against the global
    text features and vice versa (MMFL.py:298-331). Off a mesh the reps
    are a [K, N, d] tensor (or a list of [N, d]); on one, lists with None
    where another rank holds the upload."""
    out = []
    for reps, other in ((img_reps, global_txt), (txt_reps, global_img)):
        if reps is None or len(reps) == 0:
            out.append(None)
            continue
        if not M.active(mesh) and not isinstance(reps, torch.Tensor):
            reps = torch.stack(list(reps))
        reps, mask = _bucketed(reps)
        out.append(con_w_aggregate(reps, other, k_mask=mask, mesh=mesh))
    return tuple(out)
