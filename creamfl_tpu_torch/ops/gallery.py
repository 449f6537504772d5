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

Beside them, the kernels' own steps in plain PyTorch, for the CPU tests:
the per-split partials of the lse and matvec passes over the kernels'
split plan, the merges (K3's CE mode and dfeats mode among them), the
3xTF32 product of the "tc" route (``tf32_split``, ``tf32x3_matmul``)
and that of the "wgmma" route (``tf32_split_trunc``,
``wgmma_tf32x3_matmul``). The main path never calls these when a card
is present.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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


def segment_mean(x: torch.Tensor, segments: int) -> torch.Tensor:
    """Mean of ``x`` [M] (the per-row CE): a scalar for ``segments`` 1;
    else [S], the mean of each of S equal contiguous segments of rows."""
    if segments == 1:
        return torch.mean(x)
    if x.shape[0] % segments:
        raise ValueError(f"{x.shape[0]} rows do not split into {segments} "
                         "equal segments")
    return x.reshape(segments, -1).mean(dim=1)


def gallery_cross_entropy(feats: torch.Tensor, gallery: torch.Tensor,
                          labels: torch.Tensor, tau: float = 0.5,
                          blockwise: bool = False,
                          col_block: int = 8192,
                          segments: int = 1) -> torch.Tensor:
    """Mean CE of ``feats @ gallery.T / tau`` against integer ``labels``.

    The gallery is a constant (frozen global features): it gets no
    gradient (``ClientTrainer.py:370,388``). ``blockwise=True`` streams
    the logsumexp over gallery blocks under activation checkpointing, so
    the backward recomputes block logits instead of saving them.
    ``segments`` S > 1: the rows are S equal contiguous segments (the
    members of a stacked client family) and the result is the [S] vector
    of their means.
    """
    gallery = gallery.detach()
    labels = labels.long()
    if not blockwise:
        logits = (_f32(feats) @ _f32(gallery).T) / tau
        lse = torch.logsumexp(logits, dim=1)
        label_logit = logits.gather(1, labels[:, None])[:, 0]
        return segment_mean(lse - label_logit, segments)
    label_vecs = gallery.index_select(0, labels)
    label_logit = torch.sum(_f32(feats) * _f32(label_vecs), dim=1) / tau
    lse = torch.utils.checkpoint.checkpoint(
        streaming_logsumexp, feats, gallery, tau, col_block,
        use_reentrant=False)
    return segment_mean(lse - label_logit, segments)


# ---------------------------------------------------------------------------
# the kernels' steps, plain
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: on the int32 view, add half of the 13
    dropped bits' range to the magnitude and clear them. Inf and NaN pass
    through."""
    x = x.to(torch.float32).contiguous()
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 toward zero (the 13 low bits cleared): what the tensor
    core reads of an fp32 operand."""
    x = x.to(torch.float32).contiguous()
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) as the tensor core sees them: big = tf32(x) to
    nearest, small = x - big (exact) read toward zero."""
    big = tf32_round(x)
    return big, tf32_trunc(x.to(torch.float32) - big)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the "tc" kernels take it: each operand split into TF32
    halves, three products (small * big + big * small + big * big, the
    small terms first) summed in fp32; small * small is dropped."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def tf32_split_trunc(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) as the "wgmma" route's tensor core sees them: big =
    x read as TF32 (truncated), small = x - big (exact in fp32, written by
    the split pass) read truncated in its turn."""
    x = x.to(torch.float32)
    big = tf32_trunc(x)
    return big, tf32_trunc(x - big)


def wgmma_tf32x3_matmul(a: torch.Tensor, b: torch.Tensor,
                        depth: int = 32) -> torch.Tensor:
    """``a @ b`` as the "wgmma" lse pass takes it: truncated TF32 halves
    (``tf32_split_trunc``), three products (small * big + big * small +
    big * big, the small terms first) per ``depth``-deep chunk of the
    inner dimension, each chunk's sum added in fp32 to the running sum."""
    a_big, a_small = tf32_split_trunc(a)
    b_big, b_small = tf32_split_trunc(b)
    out = None
    for k0 in range(0, a.shape[1], depth):
        k = slice(k0, k0 + depth)
        chunk = (a_small[:, k] @ b_big[k] + a_big[:, k] @ b_small[k]
                 + a_big[:, k] @ b_big[k])
        out = chunk if out is None else out + chunk
    return out


def _split_ranges(n: int, splits: int, per_split: int, block_cols: int):
    for s in range(splits):
        yield s, s * per_split * block_cols, min(
            n, (s + 1) * per_split * block_cols)


def lse_partials(v: torch.Tensor, gallery: torch.Tensor, tau: float,
                 splits: int, per_split: int, block_cols: int,
                 matmul: Matmul = torch.matmul
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lse partial pass: per split of ``per_split`` column tiles of
    ``block_cols`` gallery rows, each row's (max, sum of exp(logit - max))
    -> part_max, part_sum [splits, M]; an empty split holds (-inf, 0)."""
    v32, g32 = _f32(v), _f32(gallery)
    part_max = torch.full((splits, v.shape[0]), float("-inf"),
                          device=v.device)
    part_sum = torch.zeros_like(part_max)
    for s, lo, hi in _split_ranges(g32.shape[0], splits, per_split,
                                   block_cols):
        if lo >= hi:
            continue
        logits = matmul(v32, g32[lo:hi].T) * (1.0 / tau)
        part_max[s] = logits.max(dim=1).values
        part_sum[s] = torch.exp(logits - part_max[s][:, None]).sum(dim=1)
    return part_max, part_sum


def lse_merge(part_max: torch.Tensor, part_sum: torch.Tensor
              ) -> torch.Tensor:
    """lse = max + log(sum) over the splits."""
    m = part_max.max(dim=0).values
    scale = torch.where(part_max == float("-inf"), 0.0,
                        torch.exp(part_max - m))
    return m + torch.log((part_sum * scale).sum(dim=0))


def ce_merge(part_max: torch.Tensor, part_sum: torch.Tensor,
             v: torch.Tensor, gallery: torch.Tensor, labels: torch.Tensor,
             tau: float, segments: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's forward merge: (loss [S] = the mean of lse - <v_i, g_{label_i}>
    / tau over each of S equal contiguous segments of rows, lse [M])."""
    lse = lse_merge(part_max, part_sum)
    label_vecs = _f32(gallery).index_select(0, labels.long())
    label_logit = torch.sum(_f32(v) * label_vecs, dim=1) * (1.0 / tau)
    return segment_mean(lse - label_logit, segments).reshape(segments), lse


def matvec_partials(v: torch.Tensor, gallery: torch.Tensor,
                    lse: torch.Tensor, tau: float, splits: int,
                    per_split: int, block_cols: int,
                    matmul: Matmul = torch.matmul) -> torch.Tensor:
    """The matvec partial pass: per split, exp(logit - lse) @ g_split ->
    part [splits, M, D]."""
    v32, g32 = _f32(v), _f32(gallery)
    part = torch.zeros(splits, v.shape[0], g32.shape[1], device=v.device)
    for s, lo, hi in _split_ranges(g32.shape[0], splits, per_split,
                                   block_cols):
        if lo < hi:
            probs = torch.exp(matmul(v32, g32[lo:hi].T) * (1.0 / tau)
                              - lse[:, None])
            part[s] = matmul(probs, g32[lo:hi])
    return part


def dfeats_merge(part: torch.Tensor, gallery: torch.Tensor,
                 labels: torch.Tensor, gbar: torch.Tensor, tau: float,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K3's backward merge: (sum of the splits - g_{label_i}) * gbar[s] /
    (tau * M / S) for row i of segment s, gbar [S] (one gbar, S 1: the
    whole of M), in ``dtype`` (default float32)."""
    m = part.shape[1]
    segments = gbar.numel()
    label_vecs = _f32(gallery).index_select(0, labels.long())
    if segments == 1:
        scale = gbar.to(torch.float32).reshape(()) / (tau * m)
    else:
        scale = (gbar.to(torch.float32) / (tau * (m // segments))
                 ).repeat_interleave(m // segments)[:, None]
    return ((part.sum(dim=0) - label_vecs) * scale).to(
        dtype or torch.float32)
