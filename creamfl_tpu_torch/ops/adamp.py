"""AdamP's step over a list of parameters: the plain PyTorch version and
the multi-tensor CUDA kernel (K7, ``csrc/adamp.cu``).

K7 replaces no TPU kernel: the JAX package's AdamP is plain optax code. On
the card the plain version below costs thousands of small launches a step
(about ten multi-tensor passes, then some 35 kernels per matrix for the
projection, and a copy of every channels_last conv weight for its
reshape); the kernel does the step in three launches for up to
``capacity()`` leaves (``csrc/adamp.cu`` gives its bound and design).

``adamp`` given CPU tensors runs ``adamp_reference``; given CUDA tensors it
launches the kernel or raises: every tensor fp32 (the step counts and the
lr float64) on one device, dense, each gradient and moment laid out as its
parameter, and each parameter of two or more dimensions with its rows (the
output channel, ``numel / shape[0]`` elements) contiguous in memory, as a
contiguous or a channels_last tensor has them. Both return each leaf's
mode: 0 no projection, 1 the channel view, 2 the layer view.

The wrapper counts its kernel launches in ``adamp.launches`` and
``adamp.launches_by_route`` (one route, ``"multi_tensor"``). The library
is built by ``ops.build`` at first use.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from creamfl_tpu_torch.ops import build as builder

SOURCE = builder.CSRC / "adamp.cu"
ROUTES = ("multi_tensor",)

# Tiling (must match csrc/adamp.cu): a block of 8 warps takes a tile of
# about TILE elements in whole rows; a row takes the fewest warps (1, 2, 4
# or 8) that give each lane at most 32 of its elements; a vector is cut
# into rows of at most VECTOR_ROW elements.
WARPS = 8
TILE = 16384
LANE_ELEMS = 32
VECTOR_ROW = 8192
ROWS_MASK = (1 << 24) - 1
MATRIX_BIT = 1 << 26
VECTOR_BIT = 1 << 27
_MAX_NUMEL = 2**31 - 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _cosine_max(x: torch.Tensor, y: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """max over rows of |<x_r, y_r>| / max(|x_r| |y_r|, eps)."""
    dot = (x * y).sum(1)
    return (dot.abs() / torch.clamp(x.norm(dim=1) * y.norm(dim=1),
                                    min=eps)).max()


def _project(p: torch.Tensor, g: torch.Tensor, perturb: torch.Tensor,
             delta: float, wd_ratio: float, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Channel-view, else layer-view projection; returns (perturb, wd
    factor as a 0-d tensor, mode as a 0-d int32 tensor: 0 none, 1 channel,
    2 layer). Both projections are computed and one is selected on the
    device, as the JAX code does, so a step never waits for the host."""
    rows = p.shape[0]
    pc, gc = p.reshape(rows, -1).float(), g.reshape(rows, -1).float()
    pl, gl = pc.reshape(1, -1), gc.reshape(1, -1)
    use_c = _cosine_max(gc, pc, eps) < delta / math.sqrt(pc.shape[1])
    use_l = ~use_c & (_cosine_max(gl, pl, eps)
                      < delta / math.sqrt(pl.shape[1]))
    pert_c = perturb.reshape(rows, -1)
    pn_c = pc / (pc.norm(dim=1, keepdim=True) + eps)
    proj_c = pert_c - pn_c * (pn_c * pert_c).sum(1, keepdim=True)
    pert_l = perturb.reshape(1, -1)
    pn_l = pl / (pl.norm() + eps)
    proj_l = pert_l - pn_l * (pn_l * pert_l).sum()
    out = torch.where(use_c, proj_c.reshape(p.shape),
                      torch.where(use_l, proj_l.reshape(p.shape), perturb))
    one = torch.ones((), device=p.device)
    mode = use_c.int() + 2 * use_l.int()
    return out, torch.where(use_c | use_l, wd_ratio * one, one), mode


def _one_minus_pow(beta: float, steps):
    """[1 - beta ** step] as float64 tensors, one a step tensor."""
    out = torch._foreach_pow(beta, steps)
    torch._foreach_neg_(out)
    torch._foreach_add_(out, 1.0)
    return out


def adamp_reference(params: List[torch.Tensor], grads: List[torch.Tensor],
                    exp_avgs: List[torch.Tensor],
                    exp_avg_sqs: List[torch.Tensor],
                    steps: List[torch.Tensor], lr: torch.Tensor, *,
                    beta1: float, beta2: float, eps: float,
                    weight_decay: float, delta: float, wd_ratio: float
                    ) -> torch.Tensor:
    """One AdamP step over the leaves, in place: each leaf's float64
    ``step`` incremented, its moments and the parameter updated. The
    elementwise moments and updates run as multi-tensor (foreach) kernels;
    the projection is per parameter. Returns the leaves' modes (int32)."""
    torch._foreach_add_(steps, 1.0)
    torch._foreach_mul_(exp_avgs, beta1)
    torch._foreach_add_(exp_avgs, grads, alpha=1 - beta1)
    torch._foreach_mul_(exp_avg_sqs, beta2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, value=1 - beta2)
    denom = torch._foreach_div(exp_avg_sqs, _one_minus_pow(beta2, steps))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    perturb = list(torch._foreach_div(exp_avgs, denom))
    lr_wd = lr * weight_decay
    modes = []
    for i, (p, g) in enumerate(zip(params, grads)):
        wd = None  # a float32 0-d tensor where projected
        mode = torch.zeros((), dtype=torch.int32, device=p.device)
        if p.dim() > 1:
            perturb[i], wd, mode = _project(p, g, perturb[i], delta,
                                            wd_ratio, eps)
        if weight_decay > 0:
            p.mul_(1.0 - (lr_wd if wd is None else lr_wd.float() * wd))
        modes.append(mode)
    torch._foreach_mul_(perturb, torch._foreach_div(
        [torch.neg(lr)] * len(params), _one_minus_pow(beta1, steps)))
    torch._foreach_add_(params, perturb)
    return torch.stack(modes)


# ---------------------------------------------------------------------------
# launch planning (host side; unit-tested on the CPU)
# ---------------------------------------------------------------------------

class LeafPlan(NamedTuple):
    """A leaf as the kernel walks it: rows of ``row_len`` elements (the
    last one of a vector ragged), ``rows_per_tile`` of them a block, each
    taken by ``warps`` warps."""
    numel: int
    row_len: int
    rows: int
    rows_per_tile: int
    warps: int
    matrix: bool

    @property
    def tiles(self) -> int:
        return -(-self.rows // self.rows_per_tile)


def row_length(shape: Sequence[int]) -> int:
    """The length of a row (the output channel) of a leaf of two or more
    dimensions; 0 for a vector or a scalar."""
    return math.prod(shape[1:]) if len(shape) > 1 else 0


def plan_leaf(numel: int, row_len: int) -> LeafPlan:
    """The tiling of a leaf of ``numel`` elements, a matrix of rows of
    ``row_len`` elements (``row_length``) or a vector (``row_len`` 0)."""
    matrix = row_len > 0
    if matrix:
        warps = next((w for w in (1, 2, 4) if row_len <= w * 32 * LANE_ELEMS),
                     WARPS)
        group = WARPS // warps
        per = max(group, TILE // row_len // group * group)
        return LeafPlan(numel, row_len, numel // row_len, per, warps, True)
    row_len = min(numel, VECTOR_ROW)
    return LeafPlan(numel, row_len, -(-numel // row_len),
                    max(1, TILE // row_len), WARPS, False)


@functools.lru_cache(maxsize=16)
def plan_step(shapes: Tuple[Sequence[int], ...]
              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(meta [n, 4] int32: numel, row length, info without the 16-byte bit,
    first row in the scratch; tiles [n + 1] int32: prefix sums of the
    leaves' tiles; the matrices' rows) of leaves of these shapes."""
    meta = np.zeros((len(shapes), 4), np.int64)
    tiles = np.zeros(len(shapes) + 1, np.int64)
    rows = 0
    for i, shape in enumerate(shapes):
        numel = math.prod(shape)
        plan = plan_leaf(numel, row_length(shape))
        info = (plan.rows_per_tile | (plan.warps.bit_length() - 1) << 24
                | (MATRIX_BIT if plan.matrix else 0))
        meta[i] = (numel, plan.row_len, info, rows)
        tiles[i + 1] = tiles[i] + plan.tiles
        if plan.matrix:
            rows += plan.rows
    if tiles[-1] >= 2**31 or rows >= 2**29:
        raise ValueError(f"adamp: {tiles[-1]} tiles, {rows} rows: more "
                         "than the kernel indexes")
    return meta.astype(np.int32), tiles.astype(np.int32), rows


def launches_per_step(n: int, capacity: int) -> int:
    """Kernel launches of a step over ``n`` leaves: three per launch of at
    most ``capacity`` leaves."""
    return 3 * -(-n // capacity)


@functools.lru_cache(maxsize=4096)
def _layout_problem(shape: Tuple[int, ...], stride: Tuple[int, ...]
                   ) -> Optional[str]:
    """What keeps the kernel from a leaf of this shape and these strides,
    or None: more elements than it indexes, a gap or an overlap in memory,
    or, with two or more dimensions, rows (``shape[0]`` of them) that are
    not contiguous."""
    numel = math.prod(shape)
    if not 0 < numel <= _MAX_NUMEL:
        return f"{numel} elements"
    expected = 1
    for size, step in sorted(((n, x) for n, x in zip(shape, stride)
                              if n != 1), key=lambda d: d[1]):
        if step != expected:
            return "not dense"
        expected *= size
    if len(shape) > 1 and shape[0] > 1 and stride[0] != numel // shape[0]:
        return "rows not contiguous"
    return None


def _same_layout(shape, stride, t: torch.Tensor) -> bool:
    """``t`` has ``shape`` and the same strides on every dimension longer
    than 1 (the layout autograd's gradients keep)."""
    if t.shape != shape:
        return False
    other = t.stride()
    return other == stride or all(
        n == 1 or x == y for n, x, y in zip(shape, stride, other))


def check_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, step: torch.Tensor) -> None:
    """Raise unless the kernel takes this leaf (see the module's note)."""
    if (p.dtype != torch.float32 or g.dtype != torch.float32
            or m.dtype != torch.float32 or v.dtype != torch.float32):
        raise TypeError("adamp: the kernel takes float32 parameters, "
                        f"gradients and moments, got {p.dtype}, {g.dtype}, "
                        f"{m.dtype}, {v.dtype}")
    if step.dtype != torch.float64 or step.numel() != 1:
        raise TypeError("adamp: a step count must be one float64")
    index = p.get_device()
    if (g.get_device() != index or m.get_device() != index
            or v.get_device() != index or step.get_device() != index):
        raise ValueError("adamp: a leaf's tensors on other devices than "
                         f"its parameter's, {p.device}")
    shape, stride = p.shape, p.stride()
    problem = _layout_problem(tuple(shape), stride)
    if problem:
        raise ValueError(f"adamp: a leaf of shape {tuple(shape)} and "
                         f"strides {stride}: {problem}")
    if not (_same_layout(shape, stride, g) and _same_layout(shape, stride, m)
            and _same_layout(shape, stride, v)):
        raise ValueError(f"adamp: the gradient or a moment of a leaf of "
                         f"shape {tuple(shape)} is laid out otherwise "
                         f"({stride}, {g.stride()}, {m.stride()}, "
                         f"{v.stride()})")


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/adamp.cu`` unless built already (``ops.build``).
    Returns (library path, build seconds, compiler output)."""
    return builder.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.adamp_capacity.argtypes = []
    lib.adamp_capacity.restype = i
    lib.adamp_step.argtypes = [i, p, p, p, p, d, d, d, d, d, d, p, p, p, p]
    lib.adamp_step.restype = i
    return lib


def capacity() -> int:
    """Leaves a launch of the kernel takes (its parameters hold them)."""
    return _lib().adamp_capacity()


def adamp(params: List[torch.Tensor], grads: List[torch.Tensor],
          exp_avgs: List[torch.Tensor], exp_avg_sqs: List[torch.Tensor],
          steps: List[torch.Tensor], lr: torch.Tensor, *, beta1: float,
          beta2: float, eps: float, weight_decay: float, delta: float,
          wd_ratio: float) -> torch.Tensor:
    """One AdamP step over the leaves, in place (``adamp_reference``'s
    arithmetic): on CPU tensors the plain version, on CUDA tensors the
    kernel. Returns the leaves' modes (int32 on the leaves' device)."""
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
                 delta=delta, wd_ratio=wd_ratio)
    dev = params[0].device
    if dev.type == "cpu":
        return adamp_reference(params, grads, exp_avgs, exp_avg_sqs, steps,
                               lr, **hyper)
    if lr.device != dev or lr.dtype != torch.float64 or lr.numel() != 1:
        raise TypeError("adamp: the lr must be one float64 on the "
                        "parameters' device")
    ptrs = []
    aligned = []
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        if p.get_device() != dev.index:
            raise ValueError(f"adamp: parameters on {p.device} and {dev}")
        check_leaf(p, g, m, v, s)
        ptr = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        ptrs.append(ptr + (s.data_ptr(),))
        aligned.append(not (ptr[0] | ptr[1] | ptr[2] | ptr[3]) % 16)
    meta, tiles, rows = plan_step(tuple(p.shape for p in params))
    meta = meta.copy()
    meta[:, 2] |= np.where(np.array(aligned) & (meta[:, 1] % 4 == 0),
                           VECTOR_BIT, 0).astype(np.int32)
    ptrs = np.array(ptrs, dtype=np.uint64)
    n = len(params)
    scratch = torch.empty(4 * (rows + n), dtype=torch.float32, device=dev)
    modes = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.adamp_step(
            n, ptrs.ctypes.data, meta.ctypes.data, tiles.ctypes.data,
            lr.data_ptr(), beta1, beta2, eps, weight_decay, delta, wd_ratio,
            scratch.data_ptr(), scratch.data_ptr() + 16 * rows,
            modes.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adamp: CUDA error {err} "
                           f"({torch.cuda.get_device_name(dev)})")
    launched = launches_per_step(n, lib.adamp_capacity())
    adamp.launches += launched
    adamp.launches_by_route["multi_tensor"] += launched
    return modes


_WRAPPERS = (adamp,)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launch_counts()
