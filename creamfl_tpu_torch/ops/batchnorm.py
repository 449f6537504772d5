"""Train-mode BatchNorm with its epilogue: the plain PyTorch version and
the CUDA kernel (K8, ``csrc/batchnorm.cu``).

The epilogue is what follows the normalisation in a ResNet block:
``"none"`` (a projection's BatchNorm), ``"relu"``, or ``"add_relu"``
(``relu(bn(x) + residual)``, a block's last BatchNorm). K8 replaces no TPU
kernel: the JAX package leaves BatchNorm to XLA. On the card ATen's
channels-last BatchNorm ran at ~42 % of the bandwidth, with the ReLU, its
backward and the residual add as passes of their own; K8 does the forward
in two launches (statistics, then normalise + epilogue) and the backward
in two (the channel sums, writing the residual's gradient; then dx).

``BnAct`` is the ``torch.autograd.Function`` over the kernel: CUDA
tensors only, and a raise (``check_inputs``) for what the kernel cannot
take: a bf16 4-D channels-last activation with C a multiple of 8 and
16-byte aligned, fp32 weight and bias. On the CPU the trunk runs the
unfused chain (``models/resnet.py:bn_act``), bit for bit the parity tests'
numbers; K8's backward formula is written in torch here as
``bn_act_backward_reference`` beside the chain's forward
``bn_act_reference``: the CPU tests hold it against the chain and float64,
and ``chip_smoke.py`` holds the kernel against it.

``bn_act_forward`` and ``BnAct`` return the output and ``stats`` [2, C] fp32 (the batch mean and the
inverse std it normalised with, ``1 / sqrt(var + eps)`` of the biased
variance), from which the caller moves its running statistics.

The wrappers count their launches in ``bn_act_forward.launches`` and
``bn_act_backward.launches`` (two a call), by epilogue in
``launches_by_route``. The library is built by ``ops.build`` at first use.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from creamfl_tpu_torch.ops import build as builder

SOURCE = builder.CSRC / "batchnorm.cu"
EPILOGUES = ("none", "relu", "add_relu")
_EPILOGUE_ID = {e: i for i, e in enumerate(EPILOGUES)}
ROUTES = EPILOGUES
# Must match csrc/batchnorm.cu: a block takes at most SLAB channels.
SLAB = 64
# Blocks a launch aims for on each SM.
BLOCKS_PER_SM = 2
# Rows are counted in fp32 inside the kernel: exact below 2**24.
MAX_ROWS = 2**24 - 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over ``x`` ([B, C, ...])."""
    return v.view([1, -1] + [1] * (x.dim() - 2))


def _check_epilogue(epilogue: str, residual) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"bn_act: epilogue {epilogue!r}, one of "
                         f"{EPILOGUES}")
    if (residual is not None) != (epilogue == "add_relu"):
        raise ValueError("bn_act: a residual goes with 'add_relu' alone")


def bn_act_reference(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, epilogue: str,
                     residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward by the unfused chain: (output, stats [2, C])."""
    y, mean, invstd = torch._batch_norm_impl_index(
        x, weight, bias, None, None, True, 0.0, eps,
        torch.backends.cudnn.enabled)[:3]
    if epilogue == "add_relu":
        y = y + residual
    if epilogue != "none":
        y = torch.relu(y)
    return y, torch.stack([mean, invstd])


def bn_act_backward_reference(dz: torch.Tensor, x: torch.Tensor,
                              z: Optional[torch.Tensor], weight: torch.Tensor,
                              bias: torch.Tensor, stats: torch.Tensor,
                              epilogue: str):
    """K8's backward in torch: (dx, the residual's gradient or None, dw,
    db). g = dz where the ReLU passed: for "relu" recomputed from x with
    the forward's arithmetic, for "add_relu" where the output z > 0."""
    dims = [d for d in range(x.dim()) if d != 1]
    mean, invstd = _channel(stats[0], x), _channel(stats[1], x)
    xf = x.float()
    if epilogue == "relu":
        y = (_channel(weight.float(), x) * (xf - mean) * invstd
             + _channel(bias.float(), x)).to(x.dtype)
        g = torch.where(y <= 0, torch.zeros_like(dz), dz)
    elif epilogue == "add_relu":
        g = torch.where(z <= 0, torch.zeros_like(dz), dz)
    else:
        g = dz
    gf = g.float()
    xhat = (xf - mean) * invstd
    db = gf.sum(dims)
    dw = (gf * xhat).sum(dims)
    inv_m = 1.0 / (x.numel() // x.shape[1])
    dx = _channel(weight.float() * stats[1], x) * (
        gf - _channel(db * inv_m, x) - xhat * _channel(dw * inv_m, x))
    return (dx.to(x.dtype), g if epilogue == "add_relu" else None,
            dw.to(weight.dtype), db.to(bias.dtype))


# ---------------------------------------------------------------------------
# launch planning (host side; unit-tested on the CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def plan(m: int, c: int, sms: int) -> Tuple[int, int, int]:
    """(chunks, rows a chunk, slabs): the grid of every K8 launch over
    [m, c] on a card of ``sms`` SMs, at most BLOCKS_PER_SM blocks an SM
    (one wave) where there are fewer slabs than that: slabs of at most SLAB
    channels, the rows cut into equal chunks."""
    slabs = -(-c // SLAB)
    chunks = max(1, min(m, BLOCKS_PER_SM * sms // slabs))
    rows = -(-m // chunks)
    return -(-m // rows), rows, slabs


def workspace_floats(chunks: int, slabs: int) -> int:
    """fp32 partials a launch keeps: a (mean, M2) or (sum, sum) pair per
    block and channel of its slab."""
    return slabs * chunks * 2 * SLAB


def check_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> None:
    """Raise unless the kernel takes these inputs (see the module's
    note)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"bn_act: the kernel takes a bf16 activation, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bn_act: the kernel takes a 4-D channels-last "
                         f"activation, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    c = x.shape[1]
    m = x.numel() // c if c else 0
    if c % 8 or not 0 < m <= MAX_ROWS:
        raise ValueError(f"bn_act: {c} channels (a multiple of 8) and {m} "
                         f"rows (1 to {MAX_ROWS})")
    index = x.get_device()
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or not t.is_contiguous() or t.get_device() != index):
            raise ValueError(f"bn_act: the {name} must be {c} contiguous "
                             f"fp32 on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if residual is not None:
        check_like(residual, x, "the residual")
    if x.data_ptr() % 16:
        raise ValueError("bn_act: the kernel reads 16-byte vectors; the "
                         "activation is not 16-byte aligned")


def check_like(t: torch.Tensor, x: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` is laid out as the activation ``x`` (a residual,
    a gradient) and 16-byte aligned."""
    if (t.dtype != x.dtype or t.shape != x.shape
            or t.get_device() != x.get_device()
            or not t.is_contiguous(memory_format=torch.channels_last)
            or t.data_ptr() % 16):
        raise ValueError(f"bn_act: {name} must be laid out as the "
                         "activation and 16-byte aligned")


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/batchnorm.cu`` unless built already (``ops.build``).
    Returns (library path, build seconds, compiler output)."""
    return builder.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
    lib.bn_act_slab.argtypes = []
    lib.bn_act_slab.restype = i
    if lib.bn_act_slab() != SLAB:
        raise RuntimeError("bn_act: csrc/batchnorm.cu's slab differs")
    lib.bn_act_forward.argtypes = [i, p, p, p, p, p, p, p, p, ll, i, i, i, d,
                                   p]
    lib.bn_act_forward.restype = i
    lib.bn_act_backward.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, ll,
                                    i, i, i, p]
    lib.bn_act_backward.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Workspace(NamedTuple):
    part: torch.Tensor
    tickets: torch.Tensor
    part_ptr: int
    tickets_ptr: int


# (device index, stream) -> the partials and tickets of its launches. One
# launch runs at a time on a stream, so its launches share them; the
# tickets are left at zero.
_WORKSPACE: Dict[Tuple[int, int], _Workspace] = {}


def _workspace(index: int, stream: int, chunks: int, slabs: int
               ) -> _Workspace:
    ws = _WORKSPACE.get((index, stream))
    need = workspace_floats(chunks, slabs)
    if ws is None or ws.part.numel() < need or ws.tickets.numel() < slabs:
        floor = workspace_floats(BLOCKS_PER_SM * _sms(index) + 64, 1)
        dev = torch.device("cuda", index)
        part = torch.empty(max(need, floor), dtype=torch.float32, device=dev)
        tickets = torch.zeros(max(slabs, 64), dtype=torch.int32, device=dev)
        ws = _Workspace(part, tickets, part.data_ptr(), tickets.data_ptr())
        _WORKSPACE[(index, stream)] = ws
    return ws


class _Launch(NamedTuple):
    """The geometry, workspace and stream of K8's launches over one
    activation; the backward reuses its forward's."""
    m: int
    c: int
    chunks: int
    rows: int
    ws: _Workspace
    stream: int


def _launch_plan(x: torch.Tensor) -> _Launch:
    """The launches over ``x`` on the current stream."""
    c = x.shape[1]
    m = x.numel() // c
    index = x.get_device()
    chunks, rows, slabs = plan(m, c, _sms(index))
    stream = torch._C._cuda_getCurrentRawStream(index)
    return _Launch(m, c, chunks, rows, _workspace(index, stream, chunks, slabs),
                   stream)


def _raise_on(err: int, what: str, x: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"bn_act {what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name(x.device)})")


def _forward(x, weight, bias, eps, epilogue, residual):
    """K8's forward: (output, stats, the launch plan)."""
    _check_epilogue(epilogue, residual)
    if not x.is_cuda:
        raise ValueError(f"bn_act: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    check_inputs(x, weight, bias, residual)
    launch = _launch_plan(x)
    z = torch.empty_like(x)
    stats = torch.empty(2, launch.c, dtype=torch.float32, device=x.device)
    err = _lib().bn_act_forward(
        _EPILOGUE_ID[epilogue], x.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        weight.data_ptr(), bias.data_ptr(), z.data_ptr(), stats.data_ptr(),
        launch.ws.part_ptr, launch.ws.tickets_ptr, launch.m, launch.c,
        launch.chunks, launch.rows, eps, launch.stream)
    _raise_on(err, "forward", x)
    bn_act_forward.launches += 2
    bn_act_forward.launches_by_route[epilogue] += 2
    return z, stats, launch


def _backward(dz, x, z, weight, bias, stats, epilogue, launch):
    """K8's backward over the forward's checked inputs and launch plan:
    only the gradient is checked here."""
    if not dz.is_contiguous(memory_format=torch.channels_last):
        dz = dz.contiguous(memory_format=torch.channels_last)
    check_like(dz, x, "the gradient")
    dx = torch.empty_like(x)
    g = torch.empty_like(x) if epilogue == "add_relu" else None
    sums = torch.empty(2, launch.c, dtype=torch.float32, device=x.device)
    err = _lib().bn_act_backward(
        _EPILOGUE_ID[epilogue], dz.data_ptr(), x.data_ptr(),
        z.data_ptr() if z is not None else None, weight.data_ptr(),
        bias.data_ptr(), stats.data_ptr(), dx.data_ptr(),
        g.data_ptr() if g is not None else None, sums.data_ptr(),
        launch.ws.part_ptr, launch.ws.tickets_ptr, launch.m, launch.c,
        launch.chunks, launch.rows, launch.stream)
    _raise_on(err, "backward", x)
    bn_act_backward.launches += 2
    bn_act_backward.launches_by_route[epilogue] += 2
    return dx, g, sums


def bn_act_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, epilogue: str,
                   residual: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's forward on CUDA tensors: (output, stats [2, C])."""
    z, stats, _ = _forward(x, weight, bias, eps, epilogue, residual)
    return z, stats


def bn_act_backward(dz: torch.Tensor, x: torch.Tensor,
                    z: Optional[torch.Tensor], weight: torch.Tensor,
                    bias: torch.Tensor, stats: torch.Tensor, epilogue: str
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               torch.Tensor]:
    """K8's backward on CUDA tensors: (dx, the residual's gradient or None,
    sums [2, C]: db, dw). ``x``, ``z``, ``weight``, ``bias`` and ``stats``
    are the forward's, which ``bn_act_forward`` checked; a gradient laid
    out otherwise is copied to the activation's layout."""
    return _backward(dz, x, z, weight, bias, stats, epilogue,
                     _launch_plan(x))


class BnAct(torch.autograd.Function):
    """``BnAct.apply(x, weight, bias, residual, eps, epilogue)``: (output,
    stats [2, C]: mean, inverse std) of train-mode BatchNorm of ``x`` (batch
    statistics) and its epilogue, on K8; the stats are not differentiable.
    CUDA tensors only. The backward saves x, the stats, the forward's launch
    plan and, for "add_relu", the output (the ReLU's mask, which the next
    layer keeps anyway; "relu" recomputes its mask from x)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, eps, epilogue):
        z, stats, ctx.launch = _forward(x, weight, bias, eps, epilogue,
                                        residual)
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, weight, bias, stats,
                              z if epilogue == "add_relu" else None)
        ctx.mark_non_differentiable(stats)
        # No zero tensor made for the stats' gradient.
        ctx.set_materialize_grads(False)
        return z, stats

    @staticmethod
    def backward(ctx, dz, _dstats):
        x, weight, bias, stats, z = ctx.saved_tensors
        dx, g, sums = _backward(dz, x, z, weight, bias, stats, ctx.epilogue,
                                ctx.launch)
        return dx, sums[1], sums[0], g, None, None


_WRAPPERS = (bn_act_forward, bn_act_backward)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launch_counts()
