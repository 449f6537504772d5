"""Hand-written CUDA kernels for the gallery hot loops, and their wrappers.

The kernels live in ``csrc/gallery.cu`` (sm_90a, fp32) and replace the
Pallas TPU kernels of the JAX package (``ops/pallas_gallery.py``):

* ``row_logsumexp`` (K1): row logsumexp of ``v @ g.T / tau``.
* ``softmax_matvec`` (K2): ``softmax(v @ g.T / tau) @ g`` given the lse.
* ``fused_gallery_ce`` (K3): mean CE of ``f @ g.T / tau`` vs labels, a
  ``torch.autograd.Function`` whose forward runs K1 and backward K2.
* ``conw_diag`` (K4): ``diag(log_softmax(v @ g.T))``, K1 with the
  diagonal dot folded into its merge pass.

The library is compiled by ``nvcc`` at first use from the repository's
source, into ``creamfl_tpu_torch/_build/<source hash>/``, and bound with
ctypes. A wrapper given CPU tensors runs the plain version from
``ops.gallery``; given CUDA tensors it launches the kernel or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

from creamfl_tpu_torch.ops import gallery as plain

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "gallery.cu"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Tile sizes of the kernels (must match csrc/gallery.cu).
LSE_BLOCK_ROWS, LSE_BLOCK_COLS = 128, 128
MV_BLOCK_ROWS, MV_BLOCK_COLS = 32, 64
MV_MAX_DIM = 512
# Resident blocks per SM the split heuristic aims to fill (both kernels
# run two blocks of 256 threads per SM).
_BLOCKS_PER_SM = 2


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the gallery kernels are built from "
                       "csrc/gallery.cu at first use and need the CUDA "
                       "toolkit")


def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/gallery.cu`` unless a library for this exact source
    exists. Returns (library path, build seconds, compiler output)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib = out_dir / "libgallery.so"
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libgallery.{os.getpid()}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gallery_row_lse.argtypes = [p, p, i, i, i, f, i, i, p, p, i, p, p]
    lib.gallery_row_lse.restype = i
    lib.gallery_softmax_matvec.argtypes = [p, p, p, i, i, i, f, i, i, p, p,
                                           p]
    lib.gallery_softmax_matvec.restype = i
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# launch planning (host side; unit-tested on the CPU)
# ---------------------------------------------------------------------------

def plan_splits(m: int, n: int, block_rows: int, block_cols: int,
                sm_count: int) -> Tuple[int, int]:
    """(splits, tiles_per_split) of the gallery's column tiles.

    Row blocks alone fill the card only when M is large (con_w: 391 row
    blocks of 128 at M = 50 000); at M = 128 there is one row block, so
    the column range is split across blocks until about two waves of
    resident blocks are in flight. Every split gets at least one tile.
    """
    n_tiles = -(-n // block_cols)
    row_blocks = -(-m // block_rows)
    target = 2 * _BLOCKS_PER_SM * sm_count
    splits = max(1, min(n_tiles, -(-target // row_blocks)))
    per_split = -(-n_tiles // splits)
    return -(-n_tiles // per_split), per_split


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


def _sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _launch_lse(v: torch.Tensor, g: torch.Tensor, tau: float,
                with_diag: bool) -> torch.Tensor:
    _check_inputs("gallery_row_lse", v, g)
    (m, d), n = v.shape, g.shape[0]
    if g.shape[1] != d or 0 in (m, n, d):
        raise ValueError(f"gallery_row_lse: shapes {tuple(v.shape)} and "
                         f"{tuple(g.shape)}")
    splits, per_split = plan_splits(m, n, LSE_BLOCK_ROWS, LSE_BLOCK_COLS,
                                    _sm_count(v))
    part_max = torch.empty(splits, m, dtype=torch.float32, device=v.device)
    part_sum = torch.empty_like(part_max)
    out = torch.empty(m, dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        _check(_lib().gallery_row_lse(
            v.data_ptr(), g.data_ptr(), m, n, d, 1.0 / tau, splits,
            per_split, part_max.data_ptr(), part_sum.data_ptr(),
            int(with_diag), out.data_ptr(), _stream(v)), "gallery_row_lse")
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def row_logsumexp(v: torch.Tensor, gallery: torch.Tensor,
                  tau: float = 1.0) -> torch.Tensor:
    """[M, D] x [N, D] -> [M] float32 logsumexp rows of v @ g.T / tau (K1)."""
    if v.device.type == "cpu":
        return plain.streaming_logsumexp(v, gallery, tau)
    out = _launch_lse(v, gallery, tau, with_diag=False)
    row_logsumexp.launches += 1
    return out


def conw_diag(v: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """diag(log_softmax(v @ g.T)) -> [N] float32 (K4)."""
    if v.device.type == "cpu":
        return plain.gallery_log_softmax_diag(v, gallery)
    if v.shape != gallery.shape:
        raise ValueError(f"conw_diag: shapes {tuple(v.shape)} and "
                         f"{tuple(gallery.shape)} differ")
    out = _launch_lse(v.contiguous(), gallery.contiguous(), 1.0,
                      with_diag=True)
    conw_diag.launches += 1
    return out


def softmax_matvec(v: torch.Tensor, gallery: torch.Tensor,
                   lse: torch.Tensor, tau: float = 1.0) -> torch.Tensor:
    """softmax(v @ g.T / tau) @ g -> [M, D] float32 given the row lse (K2)."""
    if v.device.type == "cpu":
        return plain.softmax_matvec(v, gallery, lse, tau)
    _check_inputs("gallery_softmax_matvec", v, gallery, lse)
    (m, d), n = v.shape, gallery.shape[0]
    if gallery.shape[1] != d or lse.shape != (m,) or 0 in (m, n, d):
        raise ValueError("gallery_softmax_matvec: shapes "
                         f"{tuple(v.shape)}, {tuple(gallery.shape)}, "
                         f"{tuple(lse.shape)}")
    if d > MV_MAX_DIM:
        raise ValueError(f"gallery_softmax_matvec: D = {d} > {MV_MAX_DIM}")
    splits, per_split = plan_splits(m, n, MV_BLOCK_ROWS, MV_BLOCK_COLS,
                                    _sm_count(v))
    part = torch.empty(splits, m, d, dtype=torch.float32, device=v.device)
    out = torch.empty(m, d, dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        _check(_lib().gallery_softmax_matvec(
            v.data_ptr(), gallery.data_ptr(), lse.data_ptr(), m, n, d,
            1.0 / tau, splits, per_split, part.data_ptr(), out.data_ptr(),
            _stream(v)), "gallery_softmax_matvec")
    softmax_matvec.launches += 1
    return out


class FusedGalleryCE(torch.autograd.Function):
    """Mean CE of ``feats @ gallery.T / tau`` vs ``labels``: K1 forward,
    K2 backward, no gradient to the gallery or the labels. On CPU tensors
    the K1/K2 wrappers run their plain versions, so the backward formula
    can be checked without a card."""

    @staticmethod
    def forward(ctx, feats, gallery, labels, tau):
        f32 = feats.to(torch.float32).contiguous()
        g32 = gallery.to(torch.float32).contiguous()
        lse = row_logsumexp(f32, g32, tau)
        label_vecs = g32.index_select(0, labels.long())
        label_logit = torch.sum(f32 * label_vecs, dim=1) / tau
        ctx.save_for_backward(f32, g32, lse, label_vecs)
        ctx.tau = tau
        ctx.feats_dtype = feats.dtype
        return torch.mean(lse - label_logit)

    @staticmethod
    def backward(ctx, gbar):
        f32, g32, lse, label_vecs = ctx.saved_tensors
        soft = softmax_matvec(f32, g32, lse, ctx.tau)
        dfeats = (soft - label_vecs) * (gbar / (ctx.tau * f32.shape[0]))
        return dfeats.to(ctx.feats_dtype), None, None, None


def fused_gallery_ce(feats: torch.Tensor, gallery: torch.Tensor,
                     labels: torch.Tensor, tau: float = 0.5) -> torch.Tensor:
    """Mean CE of ``feats @ gallery.T / tau`` vs integer ``labels`` (K3)."""
    if feats.device.type == "cpu":
        return plain.gallery_cross_entropy(feats, gallery, labels, tau=tau)
    out = FusedGalleryCE.apply(feats, gallery.detach(), labels, tau)
    fused_gallery_ce.launches += 1
    return out


_WRAPPERS = (row_logsumexp, softmax_matvec, fused_gallery_ce, conw_diag)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
