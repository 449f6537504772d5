"""con_w representation-ensemble aggregation (reference `MMFL.py:291-335`).

For each client k with public-set representations V_k in R^{N x d} and
the other modality's global features G:
    w_k = diag(log_softmax(V_k @ G.T))          (N-dim, per sample)
    alpha = softmax over clients of [w_1 ... w_K]
    aggregated = sum_k alpha_k * V_k

The diagonal never materialises the N x N logits: on the card it is the
hand-written con_w kernel (``ops.gallery_kernels.conw_diag``), on the CPU
the streamed plain version.

The sums run over the K real clients. On a mesh of ranks (``mesh``) the
uploads stay on the rank that trained their client: a slot holds this
rank's upload or None. Each rank runs the diagonal on its own uploads,
the [K, N] diagonals are summed over the ranks (each row comes from one
rank: an all-gather), every rank takes the softmax over clients, and the
sum of alpha_k V_k over each rank's own clients is summed over the ranks:
the JAX package's shard_map over the ``client`` axis and its
psum-weighted reduction. Off a mesh every slot is this process's and the
sums over ranks do nothing. The JAX package pads the client axis to a
power of two so that one compiled program serves a bucket of client
counts; a pad slot's weight is exactly 0, so the port, which compiles
nothing, runs no pad slot.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from creamfl_tpu_torch.ops import gallery_kernels
from creamfl_tpu_torch.parallel import mesh as M

Reps = Union[torch.Tensor, Sequence[Optional[torch.Tensor]]]


def con_w_aggregate(client_reps: Reps, global_other: torch.Tensor,
                    mesh: Optional[M.Mesh] = None) -> torch.Tensor:
    """K client slots ([K, N, d], or K [N, d] uploads with None where
    another rank holds one) + [N, d] other-modality globals -> [N, d]."""
    k, (n, d) = len(client_reps), global_other.shape
    dev = global_other.device
    mine = [i for i, r in enumerate(client_reps) if r is not None]
    diag = torch.zeros((k, n), dtype=torch.float32, device=dev)
    for i in mine:
        diag[i] = gallery_kernels.conw_diag(client_reps[i], global_other)
    alpha = torch.softmax(M.all_reduce_sum(mesh, diag), dim=0)
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    for i in mine:
        out += alpha[i][:, None] * client_reps[i].float()
    return M.all_reduce_sum(mesh, out)


def aggregate_modalities(img_reps: Optional[Reps],
                         txt_reps: Optional[Reps],
                         global_img: torch.Tensor,
                         global_txt: torch.Tensor,
                         mesh: Optional[M.Mesh] = None):
    """Reference ``aggregation()``: image reps weight against the global
    text features and vice versa (MMFL.py:298-331). The reps are a
    [K, N, d] tensor or a list of K slots (on a mesh, None where another
    rank holds the upload)."""
    return tuple(
        None if reps is None or len(reps) == 0
        else con_w_aggregate(reps, other, mesh=mesh)
        for reps, other in ((img_reps, global_txt), (txt_reps, global_img)))
