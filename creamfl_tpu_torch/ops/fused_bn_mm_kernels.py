"""Hand-written CUDA kernels for the fused conv+BN pair, and their wrappers.

The kernels live in ``csrc/fused_bn_mm.cu`` (sm_90a; bf16 on the tensor
cores through wmma, or fp32 FMAs; fp32 accumulation) and replace the Pallas
TPU kernels of the JAX package's ``ops/fused_bn_mm.py``:

* ``mm_bn_stats_fwd`` (K5, ``_fwd_pallas``): y = relu?(x*inv + beta) @ w and
  the column sum / sum of squares of the stored y.
* ``mm_bn_stats_bwd`` (K6, ``_bwd_pallas``): dx, dw, dinv, dbeta in one
  call, with the stat cotangents folded into dy.

Each runs on one of two routes, chosen per call by ``plan_fwd_route`` /
``plan_bwd_route`` from dtype, shape and alignment and counted in
``<wrapper>.launches_by_route``:

- ``"wgmma"`` (bf16, K and N multiples of 8, 16-byte aligned rows): an
  elementwise pass writes the operands that need a transform in bf16 (K5:
  the activation a, none at all on the identity variant without relu; K6:
  the folded dyt and a), then plain TMA + wgmma GEMMs
  (``csrc/wgmma_core.cuh``) with their epilogues;
- ``"tiled"`` (fp32, or shapes TMA cannot describe): the wmma / FMA tile
  kernels, which apply the transforms in their operand fetches.

A failed launch raises on either route; neither gives way to the other.

``MMBNStats`` (affine) and ``MMStatsIdentity`` (inv = 1, beta = 0
statically) are the ``torch.autograd.Function``s over them that
``ops.fused_bn_mm.mm_bn_stats`` applies. A wrapper given CPU tensors runs
the plain version of ``ops.fused_bn_mm``; given CUDA tensors it launches
the kernel or raises; a route asked for is checked on either device.
Each wrapper counts its launches in ``<wrapper>.launches`` and, per route,
in ``<wrapper>.launches_by_route``. The library is built by ``ops.build``
at first use.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from creamfl_tpu_torch.ops import build as builder
from creamfl_tpu_torch.ops import fused_bn_mm as plain

SOURCE = builder.CSRC / "fused_bn_mm.cu"

# Tile sizes of the kernels (must match csrc/fused_bn_mm.cu).
BLOCK_ROWS, BLOCK_COLS, BLOCK_DEPTH = 128, 64, 32
# The wgmma route's GEMM tile: 128 rows, 64 or 128 columns, depth step 64
# (must match csrc/wgmma_core.cuh).
WG_ROWS, WG_DEPTH = 128, 64
ROUTES = ("wgmma", "tiled")
_MAX_GRID_Y = 65535
# dW partials: aim for this many blocks per SM across the split, and keep
# the [splits, rows, cols] fp32 scratch under this many bytes.
_DW_BLOCKS_PER_SM = 4
_DW_PART_BYTES = 64 << 20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/fused_bn_mm.cu`` unless built already (``ops.build``).
    Returns (library path, build seconds, compiler output)."""
    return builder.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fbm_forward.argtypes = [i, i, i, p, p, p, p, i, i, i, p, p, p, p]
    lib.fbm_forward.restype = i
    lib.fbm_forward_wgmma.argtypes = [i, i, p, p, p, p, i, i, i, i, p, p, p,
                                      p, p]
    lib.fbm_forward_wgmma.restype = i
    lib.fbm_backward.argtypes = [i, i, i, p, p, p, p, p, p, p, p, i, i, i, i,
                                 i, p, p, p, p, p, p, p, p]
    lib.fbm_backward.restype = i
    lib.fbm_backward_wgmma.argtypes = [i, i, p, p, p, p, p, p, p, p, i, i, i,
                                       i, i, i, i, i, p, p, p, p, p, p, p,
                                       p, p, p]
    lib.fbm_backward_wgmma.restype = i
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# launch planning (host side; unit-tested on the CPU)
# ---------------------------------------------------------------------------

def wgmma_cols(width: int) -> int:
    """B tile width of a wgmma GEMM whose output has ``width`` columns:
    128 where it divides the width, else 64 (stage 1's K = 64)."""
    return 128 if width % 128 == 0 else 64


class DwTile(NamedTuple):
    """K6's dW product on one route: output [rows, cols] (dW [K, N] when
    ``kn``, else dW^T [N, K]), tiles of tile_rows x tile_cols, depth step
    ``depth`` rows of M."""
    rows: int
    cols: int
    tile_rows: int
    tile_cols: int
    depth: int
    kn: bool


def dw_tile(k: int, n: int, route: str) -> DwTile:
    """``"tiled"`` computes dW^T [N, K] in 128 x 64 tiles, 32 deep.
    ``"wgmma"`` puts the larger of K and N on the tile's 128 rows (dW
    [K, N] when K >= N, else dW^T [N, K]), 64 deep."""
    if route == "wgmma":
        rows, cols = max(k, n), min(k, n)
        return DwTile(rows, cols, WG_ROWS, wgmma_cols(cols), WG_DEPTH,
                      k >= n)
    return DwTile(n, k, BLOCK_ROWS, BLOCK_COLS, BLOCK_DEPTH, False)


def plan_dw_splits(m: int, k: int, n: int, sm_count: int,
                   route: str = "tiled") -> Tuple[int, int]:
    """(splits, rows_per_split) of dW's reduction over the M rows.

    dW has ceil(rows / tile rows) * ceil(cols / tile cols) output tiles
    (``dw_tile``): one at stage 1 (64 x 64), 64 to 128 at stage 4
    (2048 x 512). The rows are split until about ``_DW_BLOCKS_PER_SM``
    blocks per SM are in flight, as long as the [splits, rows, cols] fp32
    partials stay under ``_DW_PART_BYTES``. Every split is a whole number
    of the route's depth steps.
    """
    t = dw_tile(k, n, route)
    tiles = -(-t.rows // t.tile_rows) * -(-t.cols // t.tile_cols)
    depth_steps = -(-m // t.depth)
    splits = -(-_DW_BLOCKS_PER_SM * sm_count // tiles)
    splits = min(splits, depth_steps, _DW_PART_BYTES // (4 * n * k),
                 _MAX_GRID_Y)
    splits = max(1, splits)
    rows = t.depth * -(-depth_steps // splits)
    return -(-m // rows), rows


def _plan_route(dtype: torch.dtype, k: int, n: int, *tensors) -> str:
    """``"wgmma"`` needs bf16, K and N multiples of 8 and 16-byte aligned
    bases: TMA's global strides and the passes' 16-byte accesses. Anything
    else takes ``"tiled"``."""
    if dtype != torch.bfloat16 or k % 8 or n % 8:
        return "tiled"
    if any(t.data_ptr() % 16 for t in tensors):
        return "tiled"
    return "wgmma"


def plan_fwd_route(x: torch.Tensor, w_nk: torch.Tensor,
                   y: torch.Tensor) -> str:
    """K5's route for these (contiguous) operands; ``w_nk`` is W as a
    contiguous [N, K] (the conv weight's layout), ``y`` the [M, N] output."""
    return _plan_route(x.dtype, x.shape[1], w_nk.shape[0], x, w_nk, y)


def plan_bwd_route(x: torch.Tensor, w_kn: torch.Tensor, y: torch.Tensor,
                   dy: torch.Tensor) -> str:
    """K6's route for these (contiguous) operands; ``w_kn`` is W as a
    contiguous [K, N]."""
    return _plan_route(x.dtype, x.shape[1], w_kn.shape[1], x, w_kn, y, dy)


def resolve_route(name: str, asked: Optional[str], planned: str) -> str:
    """The route a wrapper takes: the planner's, unless one is asked for.
    A named route is taken as asked ("tiled" takes every input; "wgmma"
    raises where the planner would not take it), so that the two can be
    timed on the same inputs."""
    if asked is None:
        return planned
    if asked not in ROUTES or (asked == "wgmma" and planned != "wgmma"):
        raise ValueError(f"{name}: route {asked!r} does not take these "
                         f"inputs (planned: {planned!r})")
    return asked


def plan_stats_partials(m: int, n: int) -> Tuple[int, int]:
    """Shape of K5's fp32 stat partials on either route: one row per
    128-row block of y, holding the block's N column sums and then its N
    sums of squares; one merge pass sums the rows in order into [2N]
    (both routes' row blocks are 128 rows: BLOCK_ROWS == WG_ROWS)."""
    return -(-m // BLOCK_ROWS), 2 * n


def _check_inputs(name: str, x: torch.Tensor, w: torch.Tensor,
                  inv: Optional[torch.Tensor],
                  beta: Optional[torch.Tensor]) -> None:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: the kernel takes x and w both float32 or "
                        f"both bfloat16, got {x.dtype} and {w.dtype}")
    (m, k), n = x.shape, w.shape[1]
    if w.shape[0] != k or 0 in (m, k, n):
        raise ValueError(f"{name}: shapes {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if -(-m // BLOCK_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"{name}: M = {m} rows exceed the kernel's grid")
    for t in (x, w, inv, beta):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    for t in (inv, beta):
        if t is not None and (t.dtype != torch.float32 or t.shape != (k,)):
            raise TypeError(f"{name}: inv and beta must be float32 [{k}]")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def mm_bn_stats_fwd(x: torch.Tensor, w: torch.Tensor,
                    inv: Optional[torch.Tensor],
                    beta: Optional[torch.Tensor], relu: bool,
                    route: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, ssum, ssq) of relu?(x*inv + beta) @ w (K5). ``x`` [M, K], ``w``
    [K, N] in one compute dtype; ``inv``/``beta`` None: identity. ``route``
    None lets ``plan_fwd_route`` choose (see ``resolve_route``)."""
    cpu = x.device.type == "cpu"
    if not cpu:
        _check_inputs("mm_bn_stats_fwd", x, w, inv, beta)
    (m, k), n = x.shape, w.shape[1]
    x = x.contiguous()
    w_nk = w.t().contiguous()  # [N, K]: the conv weight's own layout
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    route = resolve_route("mm_bn_stats_fwd", route,
                          plan_fwd_route(x, w_nk, y))
    if cpu:
        return plain.mm_bn_stats_reference(x, w, inv, beta, relu)
    affine = inv is not None
    if affine:
        inv, beta = inv.contiguous(), beta.contiguous()
    dev = x.device
    part = torch.empty(plan_stats_partials(m, n), dtype=torch.float32,
                       device=dev)
    stats = torch.empty(2, n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "wgmma":
            act = (torch.empty(m, k, dtype=x.dtype, device=dev)
                   if affine or relu else None)
            err = _lib().fbm_forward_wgmma(
                int(affine), int(relu), x.data_ptr(), w_nk.data_ptr(),
                _ptr(inv), _ptr(beta), m, k, n, wgmma_cols(n), _ptr(act),
                y.data_ptr(), part.data_ptr(), stats.data_ptr(), stream)
        else:
            err = _lib().fbm_forward(
                _DTYPES[x.dtype], int(affine), int(relu), x.data_ptr(),
                w_nk.data_ptr(), _ptr(inv), _ptr(beta), m, k, n,
                y.data_ptr(), part.data_ptr(), stats.data_ptr(), stream)
    _check(err, f"mm_bn_stats_fwd ({route})")
    mm_bn_stats_fwd.launches += 1
    mm_bn_stats_fwd.launches_by_route[route] += 1
    return y, stats[0], stats[1]


def mm_bn_stats_bwd(x: torch.Tensor, w: torch.Tensor,
                    inv: Optional[torch.Tensor],
                    beta: Optional[torch.Tensor], y: torch.Tensor,
                    dy: torch.Tensor, dssum: torch.Tensor,
                    dssq: torch.Tensor, relu: bool,
                    route: Optional[str] = None):
    """(dx, dw [K, N], dinv, dbeta) of ``mm_bn_stats`` (K6); dinv and dbeta
    are None on the identity variant. ``route`` None lets
    ``plan_bwd_route`` choose (see ``resolve_route``)."""
    cpu = x.device.type == "cpu"
    (m, k), n = x.shape, w.shape[1]
    if not cpu:
        _check_inputs("mm_bn_stats_bwd", x, w, inv, beta)
        if (y.shape != (m, n) or dy.shape != (m, n) or y.dtype != x.dtype
                or dy.dtype != x.dtype):
            raise ValueError("mm_bn_stats_bwd: y and dy must be "
                             f"[{m}, {n}] {x.dtype}")
    x, y, dy = x.contiguous(), y.contiguous(), dy.contiguous()
    w_kn = w.contiguous()
    route = resolve_route("mm_bn_stats_bwd", route,
                          plan_bwd_route(x, w_kn, y, dy))
    if cpu:
        return plain.mm_bn_stats_backward_reference(x, w, inv, beta, y, dy,
                                                    dssum, dssq, relu)
    dssum = dssum.float().contiguous()
    dssq = dssq.float().contiguous()
    affine = inv is not None
    dev = x.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = plan_dw_splits(m, k, n, sm_count, route)
    tile = dw_tile(k, n, route)
    dx = torch.empty(m, k, dtype=x.dtype, device=dev)
    dw_out = torch.empty(tile.rows, tile.cols, dtype=x.dtype, device=dev)
    part_dw = torch.empty(splits, tile.rows, tile.cols, dtype=torch.float32,
                          device=dev)
    dinv = dbeta = part_ib = None
    if affine:
        inv, beta = inv.contiguous(), beta.contiguous()
        part_ib = torch.empty(2, -(-m // BLOCK_ROWS), k, dtype=torch.float32,
                              device=dev)
        dinv = torch.empty(k, dtype=torch.float32, device=dev)
        dbeta = torch.empty(k, dtype=torch.float32, device=dev)
    parts = (_ptr(None if part_ib is None else part_ib[0]),
             _ptr(None if part_ib is None else part_ib[1]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "wgmma":
            dyt = torch.empty(m, n, dtype=x.dtype, device=dev)
            act = (torch.empty(m, k, dtype=x.dtype, device=dev)
                   if affine or relu else None)
            err = _lib().fbm_backward_wgmma(
                int(affine), int(relu), x.data_ptr(), w_kn.data_ptr(),
                _ptr(inv), _ptr(beta), y.data_ptr(), dy.data_ptr(),
                dssum.data_ptr(), dssq.data_ptr(), m, k, n, wgmma_cols(k),
                int(tile.kn), tile.tile_cols, splits, rows,
                dyt.data_ptr(), _ptr(act), dx.data_ptr(), part_dw.data_ptr(),
                dw_out.data_ptr(), *parts, _ptr(dinv), _ptr(dbeta), stream)
        else:
            w_nk = w.t().contiguous()  # [N, K]: the conv weight's layout
            err = _lib().fbm_backward(
                _DTYPES[x.dtype], int(affine), int(relu), x.data_ptr(),
                w_nk.data_ptr(), _ptr(inv), _ptr(beta),
                y.data_ptr(), dy.data_ptr(), dssum.data_ptr(),
                dssq.data_ptr(), m, k, n, splits, rows, dx.data_ptr(),
                part_dw.data_ptr(), dw_out.data_ptr(), *parts, _ptr(dinv),
                _ptr(dbeta), stream)
    _check(err, f"mm_bn_stats_bwd ({route})")
    mm_bn_stats_bwd.launches += 1
    mm_bn_stats_bwd.launches_by_route[route] += 1
    dw = dw_out if tile.kn else dw_out.t()
    return dx, dw, dinv, dbeta


class MMBNStats(torch.autograd.Function):
    """(y, ssum, ssq) of relu?(x*inv + beta) @ w: K5 forward, K6 backward.
    On CPU tensors both run their plain versions, so the backward formula is
    checked without a card."""

    @staticmethod
    def forward(ctx, x, w, inv, beta, relu):
        y, ssum, ssq = mm_bn_stats_fwd(x, w, inv, beta, relu)
        ctx.save_for_backward(x, w, inv, beta, y)
        ctx.relu = relu
        return y, ssum, ssq

    @staticmethod
    def backward(ctx, dy, dssum, dssq):
        x, w, inv, beta, y = ctx.saved_tensors
        dx, dw, dinv, dbeta = mm_bn_stats_bwd(x, w, inv, beta, y, dy, dssum,
                                              dssq, ctx.relu)
        return dx, dw, dinv, dbeta, None


class MMStatsIdentity(torch.autograd.Function):
    """(y, ssum, ssq) of relu?(x) @ w (inv = 1, beta = 0 statically)."""

    @staticmethod
    def forward(ctx, x, w, relu):
        y, ssum, ssq = mm_bn_stats_fwd(x, w, None, None, relu)
        ctx.save_for_backward(x, w, y)
        ctx.relu = relu
        return y, ssum, ssq

    @staticmethod
    def backward(ctx, dy, dssum, dssq):
        x, w, y = ctx.saved_tensors
        dx, dw, _, _ = mm_bn_stats_bwd(x, w, None, None, y, dy, dssum, dssq,
                                       ctx.relu)
        return dx, dw, None


_WRAPPERS = (mm_bn_stats_fwd, mm_bn_stats_bwd)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
