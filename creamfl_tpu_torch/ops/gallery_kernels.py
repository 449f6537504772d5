"""Hand-written CUDA kernels for the gallery hot loops, and their wrappers.

The kernels live in ``csrc/gallery.cu`` (sm_90a, fp32 in, fp32
accumulation; the mma.sync tile core in ``csrc/gallery_core.cuh``, the
wgmma lse pass in ``csrc/gallery_wgmma.cuh``) and
replace the Pallas TPU kernels of the JAX package
(``ops/pallas_gallery.py``):

* ``row_logsumexp`` (K1): row logsumexp of ``v @ g.T / tau``.
* ``softmax_matvec`` (K2): ``softmax(v @ g.T / tau) @ g`` given the lse.
* ``fused_gallery_ce`` (K3): mean CE of ``f @ g.T / tau`` vs labels, a
  ``torch.autograd.Function``: forward K1's partial pass + a merge that
  also takes the label logits and the mean (writing the loss and the lse),
  backward K2's partial pass + a merge that writes dfeats in the
  features' dtype. Two launches each way, no torch op between them. With
  ``segments`` S the M rows are S equal contiguous segments (a stacked
  client family's members, one gallery read for all of them) and the loss
  is the [S] vector of their means.
* ``conw_diag`` (K4): ``diag(log_softmax(v @ g.T))``, K1 with the
  diagonal dot folded into its merge pass.

Each partial pass runs on one of three routes, chosen from the inputs
alone, per call and per pass, by ``plan_gallery_route`` and counted in
``<wrapper>.launches_by_route``:

- ``"wgmma"`` (the lse pass: K1, K3's forward, K4; fp32 contiguous, D % 8
  == 0, D <= 512, 16-byte aligned bases): 3xTF32 on ``wgmma``, operands
  fed by TMA (``csrc/gallery_wgmma.cuh``), their small halves from a
  pre-pass or made in shared memory as ``wgmma_split_for`` says by rows;
- ``"tc"`` (the matvec pass, K2 and K3's backward, on the same inputs):
  3xTF32 ``mma.sync`` tile kernels fed by a ``cp.async`` ring;
- ``"simt"`` (anything else): the fp32 FMA kernels of the first slice.

A failed build or launch raises on every route.

The library is compiled by ``nvcc`` at first use from the repository's
source, into ``creamfl_tpu_torch/_build/<source hash>/``, and bound with
ctypes. A wrapper given CPU tensors runs the plain version from
``ops.gallery``; given CUDA tensors it launches the kernel or raises.
Each wrapper counts its launches in ``<wrapper>.launches`` (K3 in its
forward); K3 also counts its forward pass on K1 and its backward pass on
K2, whose partial kernels it runs, and its forward launches by (rows,
segments) in ``fused_gallery_ce.launches_by_rows``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from creamfl_tpu_torch.ops import build as builder
from creamfl_tpu_torch.ops import gallery as plain

SOURCE = builder.CSRC / "gallery.cu"

ROUTES = ("wgmma", "tc", "simt")
_ROUTE_ID = {"simt": 0, "tc": 1}
# Where the wgmma lse pass takes its operands' TF32 small halves from
# (csrc/gallery_wgmma.cuh): "prepass", a split kernel into scratch before
# it, or "smem", its producer warps in shared memory, chosen by rows
# (``wgmma_split_for``).
WGMMA_SPLITS = ("prepass", "smem")
_WGMMA_ROUTE_ID = {"prepass": 2, "smem": 3}
# From this many v rows the pre-pass pays: its cost, one pass over v and g,
# is fixed, while the shared-memory split slows every gallery tile of every
# row block. On an H100 (chip_smoke.py's time_wgmma_splits) "smem" is the
# faster at K1's 128 rows, the two tie near 384 and "prepass" is the
# faster from 1024 rows up to K4's 50 000.
WGMMA_PREPASS_ROWS = 512
# Tile sizes of the kernels (must match csrc/gallery.cu). simt: K1 128 x
# 128, K2 32 rows x 64 gallery rows. tc (K2): see ``mv_tc_tile``, in
# 32-float depth chunks.
LSE_BLOCK_ROWS, LSE_BLOCK_COLS = 128, 128
MV_BLOCK_ROWS, MV_BLOCK_COLS = 32, 64
TC_DEPTH = 32
MV_MAX_DIM = 512
# wgmma lse: 128 v rows x 128 gallery rows a tile, 3 stages of four 128 x
# 32 fp32 boxes (64 KB) behind 1 KB of alignment and 9 barriers: one
# block an SM (gallery_wgmma.cuh kSmemBytes).
WGMMA_ROWS, WGMMA_COLS, WGMMA_STAGES = 128, 128, 3
WGMMA_SMEM_BYTES = 1024 + WGMMA_STAGES * 4 * WGMMA_COLS * TC_DEPTH * 4 + 72
# Resident blocks per SM the simt split heuristic aims to fill (both
# kernels run two blocks of 256 threads per SM), and an SM's shared memory
# (228 KB, 1 KB of it reserved per block). On the CPU, plans use the
# H100's 132 SMs.
_BLOCKS_PER_SM = 2
_SM_SHARED_BYTES, _BLOCK_RESERVED_BYTES = 233_472, 1024
_BLOCK_SHARED_MAX = 232_448
_H100_SMS = 132
# K3's merge modes (csrc/gallery.cu LseMode).
_LSE, _DIAG, _CE = 0, 1, 2


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/gallery.cu`` unless built already (``ops.build``).
    Returns (library path, build seconds, compiler output)."""
    return builder.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gallery_lse.argtypes = [i, p, p, i, i, i, f, i, i, p, p, i, p, i, p,
                                p, p, p, p]
    lib.gallery_lse.restype = i
    lib.gallery_matvec.argtypes = [i, p, p, p, i, i, i, f, i, i, p, i, p, p,
                                   i, f, i, p, p]
    lib.gallery_matvec.restype = i
    lib.gallery_tc_peak.argtypes = [i, i, p, p]
    lib.gallery_tc_peak.restype = i
    lib.gallery_wgmma_peak.argtypes = [i, i, p, p]
    lib.gallery_wgmma_peak.restype = i
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# launch planning (host side; unit-tested on the CPU)
# ---------------------------------------------------------------------------

def padded_dim(d: int) -> int:
    """D rounded up to the tc tiles' row pitch (32 floats)."""
    return -(-d // TC_DEPTH) * TC_DEPTH


def mv_tc_tile(d: int) -> Tuple[int, int, int]:
    """(v rows per block, gallery rows per tile, ring stages) of the tc
    matvec kernel at D: 64 x 64 up to a padded D of 256, else 32 x 32."""
    return (64, 64, 2) if padded_dim(d) <= 256 else (32, 32, 2)


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the tc matvec kernel at D
    (csrc/gallery.cu: matvec_tc_smem)."""
    rows, cols, stages = mv_tc_tile(d)
    return 4 * ((rows + stages * cols) * padded_dim(d) + 2 * rows * (cols + 4))


def tc_blocks_per_sm(d: int) -> int:
    """Resident tc matvec blocks per SM by shared memory (its launch
    bounds allow one)."""
    return min(1, _SM_SHARED_BYTES // (tc_smem_bytes(d)
                                       + _BLOCK_RESERVED_BYTES))


def plan_splits(m: int, n: int, block_rows: int, block_cols: int,
                sm_count: int, blocks: Optional[int] = None
                ) -> Tuple[int, int]:
    """(splits, tiles_per_split) of the gallery's column tiles.

    Row blocks alone fill the card only when M is large (con_w: 391 row
    blocks of 128 at M = 50 000); at M = 128 there are one or two, so the
    column range is split across blocks until about ``blocks`` are in
    flight (default: two waves of the simt kernels' resident blocks).
    Every split gets at least one tile.
    """
    if blocks is None:
        blocks = 2 * _BLOCKS_PER_SM * sm_count
    n_tiles = -(-n // block_cols)
    row_blocks = -(-m // block_rows)
    splits = max(1, min(n_tiles, -(-blocks // row_blocks)))
    per_split = -(-n_tiles // splits)
    return -(-n_tiles // per_split), per_split


def lse_cols(route: str) -> int:
    """Gallery rows in a column tile of the lse pass on ``route``."""
    return {"wgmma": WGMMA_COLS, "simt": LSE_BLOCK_COLS}[route]


def plan_for(kernel: str, route: str, m: int, n: int, d: int,
             sm_count: int) -> Tuple[int, int]:
    """(splits, tiles_per_split) of ``kernel`` ("lse" or "matvec") on
    ``route``. wgmma (the lse pass) and tc (the matvec pass) aim at one
    wave of resident blocks, so that each block walks many gallery tiles
    (one block an SM on both)."""
    if route == "simt":
        rows, cols = ((LSE_BLOCK_ROWS, LSE_BLOCK_COLS) if kernel == "lse"
                      else (MV_BLOCK_ROWS, MV_BLOCK_COLS))
        return plan_splits(m, n, rows, cols, sm_count)
    if (kernel, route) == ("lse", "wgmma"):
        return plan_splits(m, n, WGMMA_ROWS, WGMMA_COLS, sm_count,
                           blocks=sm_count)
    if (kernel, route) == ("matvec", "tc"):
        return plan_splits(m, n, *mv_tc_tile(d)[:2], sm_count,
                           blocks=tc_blocks_per_sm(d) * sm_count)
    raise ValueError(f"the {kernel} pass has no {route!r} route (wgmma runs "
                     "the lse pass only, tc the matvec pass only)")


def wgmma_split_for(m: int) -> str:
    """The wgmma lse pass's source of small halves for ``m`` v rows:
    ``"prepass"`` from ``WGMMA_PREPASS_ROWS`` rows on, else ``"smem"``."""
    return "prepass" if m >= WGMMA_PREPASS_ROWS else "smem"


def plan_gallery_route(kernel: str, *tensors: torch.Tensor) -> str:
    """The route of ``kernel``'s pass ("lse" or "matvec") on these
    operands: for fp32 contiguous operands with D = the last dim of the
    first, D % 8 == 0, D <= 512 and 16-byte aligned bases, ``"wgmma"`` for
    the lse pass and ``"tc"`` for the matvec pass; else ``"simt"``. A plan
    by shape: no route gives way to another."""
    d = tensors[0].shape[-1]
    if d % 8 or d > MV_MAX_DIM:
        return "simt"
    for t in tensors:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            return "simt"
    return "wgmma" if kernel == "lse" else "tc"


def matvec_route(lse_route: str) -> str:
    """K3's backward route for its forward's: the wgmma route's inputs go
    to ``"tc"``, as the planner sends the matvec pass."""
    return "tc" if lse_route == "wgmma" else lse_route


def _check_inputs(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _check_shapes(name: str, v: torch.Tensor, g: torch.Tensor) -> None:
    if v.dim() != 2 or g.dim() != 2 or g.shape[1] != v.shape[1] or (
            0 in (*v.shape, g.shape[0])):
        raise ValueError(f"{name}: shapes {tuple(v.shape)} and "
                         f"{tuple(g.shape)}")


def _sm_count(t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        return _H100_SMS
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _count(fn, route: str) -> None:
    fn.launches += 1
    fn.launches_by_route[route] += 1


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _lse_launch(v: torch.Tensor, g: torch.Tensor, tau: float, mode: int,
                route: str, labels: Optional[torch.Tensor] = None,
                segments: int = 1):
    """The lse partial pass on ``route`` + the merge in ``mode``: returns
    out [M] (lse, or diag - lse), and for ``_CE`` (loss [segments], lse).
    The wgmma route takes its small halves as ``wgmma_split_for(M)`` says;
    "prepass" allocates their scratch here."""
    (m, d), n = v.shape, g.shape[0]
    splits, per_split = plan_for("lse", route, m, n, d, _sm_count(v))
    part_max = torch.empty(m, splits, dtype=torch.float32, device=v.device)
    part_sum = torch.empty_like(part_max)
    out = torch.empty(m, dtype=torch.float32, device=v.device)
    loss = (torch.empty(segments, dtype=torch.float32, device=v.device)
            if mode == _CE else None)
    v_small = g_small = None
    if route != "wgmma":
        route_id = _ROUTE_ID[route]
    else:
        split = wgmma_split_for(m)
        route_id = _WGMMA_ROUTE_ID[split]
        if split == "prepass":
            v_small, g_small = torch.empty_like(v), torch.empty_like(g)
    with torch.cuda.device(v.device):
        _check(_lib().gallery_lse(
            route_id, v.data_ptr(), g.data_ptr(), m, n, d, 1.0 / tau,
            splits, per_split, part_max.data_ptr(), part_sum.data_ptr(),
            mode, _ptr(labels), m // segments, out.data_ptr(), _ptr(loss),
            _ptr(v_small), _ptr(g_small), _stream(v)),
            f"gallery_lse ({route})")
    return out if loss is None else (loss, out)


def _matvec_launch(v: torch.Tensor, g: torch.Tensor, lse: torch.Tensor,
                   tau: float, route: str,
                   labels: Optional[torch.Tensor] = None,
                   gbar: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The matvec partial pass on ``route`` + the merge: the [M, D] sum,
    or with ``labels`` and ``gbar`` ([S], one per segment of M / S rows)
    K3's dfeats in ``out_dtype``."""
    (m, d), n = v.shape, g.shape[0]
    if d > MV_MAX_DIM:
        raise ValueError(f"gallery_matvec: D = {d} > {MV_MAX_DIM}")
    splits, per_split = plan_for("matvec", route, m, n, d, _sm_count(v))
    part = torch.empty(splits, m, d, dtype=torch.float32, device=v.device)
    out = torch.empty(m, d, dtype=out_dtype, device=v.device)
    seg_rows = m if gbar is None else m // gbar.numel()
    with torch.cuda.device(v.device):
        _check(_lib().gallery_matvec(
            _ROUTE_ID[route], v.data_ptr(), g.data_ptr(), lse.data_ptr(), m,
            n, d, 1.0 / tau, splits, per_split, part.data_ptr(),
            int(labels is not None), _ptr(labels), _ptr(gbar), seg_rows,
            float(tau * seg_rows), int(out_dtype == torch.bfloat16),
            out.data_ptr(), _stream(v)), f"gallery_matvec ({route})")
    return out


def wgmma_peak(blocks: int, iters: int, device) -> torch.Tensor:
    """Launch the wgmma TF32 rate probe (``wgmma_peak_kernel``): blocks x 2
    warpgroups x iters x 12 m64n128k8 products from shared memory, 2 * 64
    * 128 * 8 operations each. A measurement of the card, used by
    ``chip_smoke.py``; returns the per-thread sums."""
    out = torch.empty(blocks * 256, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        _check(_lib().gallery_wgmma_peak(blocks, iters, out.data_ptr(),
                                         _stream(out)), "gallery_wgmma_peak")
    return out


def tc_peak(blocks: int, iters: int, device) -> torch.Tensor:
    """Launch the mma.sync TF32 rate probe (``tc_peak_kernel``): blocks x 8
    warps x iters x 8 m16n8k8 products, 2 * 16 * 8 * 8 operations each.
    A measurement of the card, used by ``chip_smoke.py``; returns the
    per-thread sums."""
    out = torch.empty(blocks * 256, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        _check(_lib().gallery_tc_peak(blocks, iters, out.data_ptr(),
                                      _stream(out)), "gallery_tc_peak")
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def row_logsumexp(v: torch.Tensor, gallery: torch.Tensor,
                  tau: float = 1.0) -> torch.Tensor:
    """[M, D] x [N, D] -> [M] float32 logsumexp rows of v @ g.T / tau (K1)."""
    if v.device.type == "cpu":
        return plain.streaming_logsumexp(v, gallery, tau)
    route = plan_gallery_route("lse", v, gallery)
    _check_inputs("row_logsumexp", v, gallery)
    _check_shapes("row_logsumexp", v, gallery)
    out = _lse_launch(v, gallery, tau, _LSE, route)
    _count(row_logsumexp, route)
    return out


def conw_diag(v: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """diag(log_softmax(v @ g.T)) -> [N] float32 (K4)."""
    if v.shape != gallery.shape:
        raise ValueError(f"conw_diag: shapes {tuple(v.shape)} and "
                         f"{tuple(gallery.shape)} differ")
    v, gallery = v.contiguous(), gallery.contiguous()
    if v.device.type == "cpu":
        return plain.gallery_log_softmax_diag(v, gallery)
    route = plan_gallery_route("lse", v, gallery)
    _check_inputs("conw_diag", v, gallery)
    _check_shapes("conw_diag", v, gallery)
    out = _lse_launch(v, gallery, 1.0, _DIAG, route)
    _count(conw_diag, route)
    return out


def softmax_matvec(v: torch.Tensor, gallery: torch.Tensor,
                   lse: torch.Tensor, tau: float = 1.0) -> torch.Tensor:
    """softmax(v @ g.T / tau) @ g -> [M, D] float32 given the row lse (K2)."""
    if v.device.type == "cpu":
        return plain.softmax_matvec(v, gallery, lse, tau)
    route = plan_gallery_route("matvec", v, gallery)
    _check_inputs("softmax_matvec", v, gallery, lse)
    _check_shapes("softmax_matvec", v, gallery)
    if lse.shape != (v.shape[0],):
        raise ValueError(f"softmax_matvec: lse shape {tuple(lse.shape)}")
    out = _matvec_launch(v, gallery, lse, tau, route)
    _count(softmax_matvec, route)
    return out


def _check_segments(name: str, m: int, segments: int) -> None:
    if segments < 1 or m % segments:
        raise ValueError(f"{name}: {m} rows do not split into {segments} "
                         "equal segments")


class FusedGalleryCE(torch.autograd.Function):
    """Mean CE of ``feats @ gallery.T / tau`` vs ``labels``, no gradient to
    the gallery or the labels. Forward: K1's partial pass and the CE-mode
    merge (loss and lse), on ``plan_gallery_route``'s route; backward:
    K2's partial pass and the dfeats-mode merge, with gbar read from the
    device, on ``matvec_route`` of it. ``segments`` S > 1: the loss is
    [S], one mean per equal contiguous segment of rows, and gbar [S]. On
    CPU tensors both run their plain steps (``ops.gallery``: partials over
    the same split plan, then the merges), so the formulas are checked
    without a card."""

    @staticmethod
    def forward(ctx, feats, gallery, labels, tau, segments=1):
        f32 = feats.to(torch.float32).contiguous()
        g32 = gallery.to(torch.float32).contiguous()
        labels = labels.to(torch.int64).contiguous()
        route = plan_gallery_route("lse", f32, g32)
        (m, d), n = f32.shape, g32.shape[0]
        _check_segments("fused_gallery_ce", m, segments)
        if f32.device.type == "cpu":
            splits, per_split = plan_for("lse", route, m, n, d,
                                         _sm_count(f32))
            loss, lse = plain.ce_merge(
                *plain.lse_partials(f32, g32, tau, splits, per_split,
                                    lse_cols(route)),
                f32, g32, labels, tau, segments)
        else:
            _check_inputs("fused_gallery_ce", f32, g32)
            _check_shapes("fused_gallery_ce", f32, g32)
            loss, lse = _lse_launch(f32, g32, tau, _CE, route, labels,
                                    segments)
            _count(row_logsumexp, route)
            _count(fused_gallery_ce, route)
            rows = fused_gallery_ce.launches_by_rows
            rows[(m, segments)] = rows.get((m, segments), 0) + 1
        ctx.save_for_backward(f32, g32, lse, labels)
        ctx.tau, ctx.feats_dtype = tau, feats.dtype
        ctx.route = matvec_route(route)
        return loss.reshape(()) if segments == 1 else loss

    @staticmethod
    def backward(ctx, gbar):
        f32, g32, lse, labels = ctx.saved_tensors
        gbar = gbar.to(torch.float32).reshape(-1)
        if f32.device.type == "cpu":
            (m, d), n = f32.shape, g32.shape[0]
            splits, per_split = plan_for("matvec", ctx.route, m, n, d,
                                         _sm_count(f32))
            cols = mv_tc_tile(d)[1] if ctx.route == "tc" else MV_BLOCK_COLS
            dfeats = plain.dfeats_merge(
                plain.matvec_partials(f32, g32, lse, ctx.tau, splits,
                                      per_split, cols),
                g32, labels, gbar, ctx.tau, ctx.feats_dtype)
        else:
            if ctx.feats_dtype not in (torch.float32, torch.bfloat16):
                raise TypeError("fused_gallery_ce: dfeats in float32 or "
                                f"bfloat16, not {ctx.feats_dtype}")
            dfeats = _matvec_launch(f32, g32, lse, ctx.tau, ctx.route,
                                    labels, gbar.contiguous(),
                                    ctx.feats_dtype)
            _count(softmax_matvec, ctx.route)
        return dfeats, None, None, None, None


def fused_gallery_ce(feats: torch.Tensor, gallery: torch.Tensor,
                     labels: torch.Tensor, tau: float = 0.5,
                     segments: int = 1) -> torch.Tensor:
    """Mean CE of ``feats @ gallery.T / tau`` vs integer ``labels`` (K3): a
    scalar, or with ``segments`` S > 1 the [S] means of S equal contiguous
    segments of rows, in one launch each way (``FusedGalleryCE``). Labels
    must lie in [0, N) (the kernels give NaN otherwise)."""
    if feats.device.type == "cpu":
        return plain.gallery_cross_entropy(feats, gallery, labels, tau=tau,
                                           segments=segments)
    return FusedGalleryCE.apply(feats, gallery.detach(), labels, tau,
                                segments)


_WRAPPERS = (row_logsumexp, softmax_matvec, fused_gallery_ce, conw_diag)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)
    fused_gallery_ce.launches_by_rows = {}


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
