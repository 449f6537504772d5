"""Fused (BN-normalise -> ReLU ->) 1x1-conv matmul with a BN-stats epilogue.

A bottleneck's 1x1 convs are matmuls over channels-last pixel rows, so the
previous BatchNorm's normalise + relu, the product and the batch stats of
its output can be one pass over memory:

    a = relu?(x * inv + beta)      # previous BN folded: inv = s*rsqrt(
    y = a @ w                      #   var+eps), beta = b - mean*inv
    ssum, ssq = col-sums of y, y^2 # batch stats of the STORED y

This module holds the plain PyTorch versions (``mm_bn_stats_reference``
forward, ``mm_bn_stats_backward_reference`` backward, each split into the
steps of the kernels' wgmma route) and the entry point
``mm_bn_stats``, a ``torch.autograd.Function`` whose forward and backward
go through the wrappers of ``ops.fused_bn_mm_kernels``: CUDA tensors run the
hand-written kernels (K5 forward, K6 backward), CPU tensors these plain
versions. Semantics are those of the JAX package's ``ops/fused_bn_mm.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of two compute-dtype operands with fp32 accumulation and an
    fp32 result: bf16 values are exact in fp32, so this is the bf16 product
    with an fp32 accumulator, rounded nowhere."""
    return torch.matmul(a.float(), b.float())


def activation_reference(x: torch.Tensor, inv: Optional[torch.Tensor],
                         beta: Optional[torch.Tensor], relu: bool,
                         dtype: torch.dtype) -> torch.Tensor:
    """a = relu?(x * inv + beta) in fp32, rounded once to ``dtype``
    (relu?(x) on the identity variant, ``inv`` and ``beta`` None): the
    operand of K5's product and of K6's dW product."""
    if inv is None:
        a = torch.relu(x) if relu else x
    else:
        a = x.float() * inv + beta
        if relu:
            a = torch.relu(a)
    return a.to(dtype)


def mm_stats_reference(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, ssum, ssq): y = a @ w with fp32 accumulation, rounded to
    ``dtype`` BEFORE the stats are taken (as the unfused conv's stored
    output is); ssum and ssq the fp32 column sums of y and y^2."""
    y = _matmul_f32(a, w).to(dtype)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def mm_bn_stats_reference(x: torch.Tensor, w: torch.Tensor,
                          inv: Optional[torch.Tensor],
                          beta: Optional[torch.Tensor],
                          relu: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Plain forward (what K5 computes), in the two steps of its wgmma
    route: the activation (``activation_reference``), then the product with
    its stats (``mm_stats_reference``). ``x`` [M, K], ``w`` [K, N] (both in
    the compute dtype), ``inv``/``beta`` [K] fp32, or both None for the
    identity variant. Returns (y [M, N] in x.dtype, ssum [N] fp32, ssq [N]
    fp32). Differentiable by autograd."""
    return mm_stats_reference(activation_reference(x, inv, beta, relu,
                                                   w.dtype), w, x.dtype)


def bwd_prologue_reference(
        x: torch.Tensor, inv: Optional[torch.Tensor],
        beta: Optional[torch.Tensor], y: torch.Tensor, dy: torch.Tensor,
        dssum: torch.Tensor, dssq: torch.Tensor, relu: bool,
        dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dyt, a) in ``dtype``: the operands of K6's two products.

    The stat cotangents fold into dy in fp32 from the stored y
    (d ssum/dy = 1, d ssq/dy = 2y) and the folded dyt is rounded once;
    a is ``activation_reference``."""
    dyt = (dy.float() + dssum) + (2.0 * y.float()) * dssq
    return dyt.to(dtype), activation_reference(x, inv, beta, relu, dtype)


def bwd_dx_reference(
        x: torch.Tensor, w: torch.Tensor, inv: Optional[torch.Tensor],
        beta: Optional[torch.Tensor], dyt: torch.Tensor, relu: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dinv, dbeta) from the folded dyt: da = dyt @ w^T in fp32, masked
    where the pre-activation (x * inv + beta in fp32, or x on the identity
    variant) is not > 0; dx = da * inv rounded to x's dtype, dinv and dbeta
    the fp32 column sums of da * x and da (None on the identity variant)."""
    da = _matmul_f32(dyt, w.t())
    zero = torch.zeros((), dtype=da.dtype)
    if inv is None:
        if relu:
            da = torch.where(x > 0, da, zero)
        return da.to(x.dtype), None, None
    xf = x.float()
    if relu:
        da = torch.where(xf * inv + beta > 0, da, zero)
    return (da * inv).to(x.dtype), (da * xf).sum(0), da.sum(0)


def bwd_dw_reference(a: torch.Tensor, dyt: torch.Tensor) -> torch.Tensor:
    """dW = a^T @ dyt with fp32 accumulation, rounded to the operands'
    dtype."""
    return _matmul_f32(a.t(), dyt).to(dyt.dtype)


def mm_bn_stats_backward_reference(
        x: torch.Tensor, w: torch.Tensor, inv: Optional[torch.Tensor],
        beta: Optional[torch.Tensor], y: torch.Tensor, dy: torch.Tensor,
        dssum: torch.Tensor, dssq: torch.Tensor, relu: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """Plain backward of ``mm_bn_stats`` (what K6 computes), in the three
    steps of its wgmma route: the prologue (``bwd_prologue_reference``),
    the dx product (``bwd_dx_reference``), the dW product
    (``bwd_dw_reference``). ``inv`` and ``beta`` None select the identity
    variant, which returns no dinv/dbeta.
    Returns (dx in x.dtype, dw [K, N] in w.dtype, dinv, dbeta fp32)."""
    dyt, a = bwd_prologue_reference(x, inv, beta, y, dy, dssum, dssq, relu,
                                    w.dtype)
    dx, dinv, dbeta = bwd_dx_reference(x, w, inv, beta, dyt, relu)
    return dx, bwd_dw_reference(a, dyt), dinv, dbeta


def mm_bn_stats(x: torch.Tensor, w: torch.Tensor,
                inv: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None, relu: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """relu?(x * inv + beta) @ w with column sum / sum-of-squares outputs.

    ``x`` [M, K] (compute dtype), ``w`` [K, N] (cast to x.dtype here, so an
    fp32 parameter gets its gradient through the cast), ``inv``/``beta``
    [K] fp32 -- both None for the identity variant (no affine; neither
    dinv nor dbeta). Returns (y [M, N] in x.dtype, ssum [N], ssq [N] fp32).
    """
    from creamfl_tpu_torch.ops import fused_bn_mm_kernels as kernels

    w = w.to(x.dtype)
    if (inv is None) != (beta is None):
        raise ValueError("mm_bn_stats: pass both inv and beta, or neither")
    if inv is None:
        return kernels.MMStatsIdentity.apply(x, w, relu)
    return kernels.MMBNStats.apply(x, w, inv, beta, relu)
