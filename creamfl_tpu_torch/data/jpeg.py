"""JPEG files: their size from the header, and their pixels on a device.

The JAX package opens every image with PIL on the host
(``data/coco.py``, ``data/flickr30k.py``). Here:

* ``jpeg_size(data)`` parses the frame header (SOF0, SOF1, SOF2 and the
  other SOF markers) on the host: the transforms' draws need the size
  alone, so a sample's recipe is drawn without decoding it.
* ``decode_batch(datas, device)`` decodes a batch into one padded
  ``[B, Hmax, Wmax, 3]`` uint8 tensor on ``device``, image ``b`` in the
  top-left ``(w, h)`` corner of its slot (the rest is zero). On the card
  it is nvJPEG (``csrc/jpeg.cu``, built with ``ops.build`` at first use
  and bound with ctypes), each image decoded straight into its slot; on
  the CPU (the tests) it is PIL, imported at the first call, and its
  absence raises. ``decode`` gives the same images as a list.

Grayscale files come out as RGB with the gray value in every channel, as
PIL's ``convert("RGB")`` gives. A file that the decoder cannot read (not a
JPEG, CMYK, a size that differs from its header's) raises an error that
names it. ``decode_batch.images_by_route`` counts the images decoded by
``"nvjpeg"`` and by ``"pil"``.
"""

from __future__ import annotations

import ctypes
import functools
import io
import os
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from creamfl_tpu_torch.ops import build as builder

SOURCE = builder.CSRC / "jpeg.cu"
# Start-of-frame markers: every 0xC0-0xCF but DHT (C4), JPG (C8) and DAC
# (CC). The baseline (SOF0), extended (SOF1) and progressive (SOF2) ones are
# the ones cameras and libjpeg write.
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# Markers without a length field: TEM, RST0-7, SOI.
_STANDALONE = frozenset([0x01, 0xD8, *range(0xD0, 0xD8)])
# Bytes read for a header before the whole file is read.
HEADER_BYTES = 1 << 16
_NVJPEG_ERRORS = {
    2: "invalid parameter", 3: "bad JPEG data", 4: "JPEG format not "
    "supported by nvJPEG", 5: "allocator failure", 6: "execution failed",
    7: "architecture mismatch", 8: "internal error",
    102: "its planes differ from its frame header's", 103: "bad device "
    "ordinal"}


class JpegError(ValueError):
    """A file that is not a JPEG or that the decoder refuses."""


class JpegInfo(NamedTuple):
    """What the frame header says: the size, the components' sampling
    factors (h, v) and the Adobe colour transform (-1 without APP14)."""
    width: int
    height: int
    factors: Tuple[Tuple[int, int], ...]
    component_ids: Tuple[int, ...]
    adobe_transform: int


def jpeg_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(width, height) from the frame header of a JPEG file's bytes."""
    info = jpeg_info(data, name)
    return info.width, info.height


def jpeg_info(data: bytes, name: str = "<bytes>") -> JpegInfo:
    """Parse the markers up to the frame header (SOF)."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError(f"{name}: not a JPEG file (no SOI marker)")
    i, n = 2, len(data)
    adobe = -1
    while i < n:
        if data[i] != 0xFF:
            raise JpegError(f"{name}: corrupt JPEG header at byte {i}")
        while i < n and data[i] == 0xFF:  # fill bytes
            i += 1
        if i >= n:
            break
        marker = data[i]
        i += 1
        if marker in _STANDALONE:
            continue
        if marker == 0xD9 or i + 2 > n:  # EOI, or cut short
            break
        length = (data[i] << 8) | data[i + 1]
        if marker == 0xEE and data[i + 2:i + 7] == b"Adobe" and length >= 12:
            adobe = data[i + 13]
        if marker in _SOF:
            ncomp = data[i + 7] if i + 8 <= n else 0
            if ncomp == 0 or i + 8 + 3 * ncomp > n:
                break
            h = (data[i + 3] << 8) | data[i + 4]
            w = (data[i + 5] << 8) | data[i + 6]
            comps = [data[i + 8 + 3 * c:i + 11 + 3 * c] for c in range(ncomp)]
            return JpegInfo(w, h, tuple((c[1] >> 4, c[1] & 15)
                                        for c in comps),
                            tuple(c[0] for c in comps), adobe)
        if marker == 0xDA:  # start of scan before any frame header
            break
        i += length
    raise JpegError(f"{name}: no frame header (SOF) found")


def read_size(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG file, reading its header only."""
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
        try:
            return jpeg_size(head, path)
        except JpegError:
            if len(head) < HEADER_BYTES:
                raise
            return jpeg_size(head + f.read(), path)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/jpeg.cu`` against nvJPEG unless built already."""
    lib_dir = builder.toolkit_lib_dir()
    return builder.build(SOURCE, link=("-lnvjpeg", "-Xlinker",
                                       f"-rpath={lib_dir}"))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jpeg_decode.argtypes = [i, i, p, p, p, p, p, p, ctypes.c_longlong, i,
                                i, i, p, p]
    lib.jpeg_decode.restype = i
    return lib


def _pil_rgb(data: bytes, name: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding JPEG files on the CPU needs PIL "
                           "(Pillow), which is not installed; decode on "
                           "the card instead") from e
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.array(im.convert("RGB"))
    except Exception as e:  # PIL raises several types for bad files
        raise JpegError(f"{name}: PIL cannot decode it ({e})") from e


def _plane_meta(info: JpegInfo, name: str) -> List[int]:
    """[y_off, cb_off, cr_off, w, h, cw, ch, mode, hfac, vfac] with the
    offsets 0, and the upsampling mode libjpeg-turbo picks
    (jdsample.c:jinit_upsampler, with its default fancy upsampling)."""
    w, h, f = info.width, info.height, info.factors
    if w < 1 or h < 1 or any(not 1 <= x <= 4 for fac in f for x in fac):
        raise JpegError(f"{name}: bad frame header (size {w} x {h}, "
                        f"sampling factors {f})")
    if len(f) == 1:
        return [0, 0, 0, w, h, 0, 0, GRAY, 1, 1]
    if len(f) != 3:
        raise JpegError(f"{name}: {len(f)} colour components (CMYK or "
                        "YCCK); the decoder takes gray and YCbCr files")
    if info.adobe_transform == 0 or info.component_ids == (82, 71, 66):
        raise JpegError(f"{name}: RGB-coded JPEG; the decoder takes gray "
                        "and YCbCr files")
    (h0, v0), (h1, v1) = f[0], f[1]
    if f[2] != f[1] or h0 % h1 or v0 % v1 or max(a for a, _ in f) != h0 \
            or max(b for _, b in f) != v0:
        raise JpegError(f"{name}: sampling factors {f} are not supported")
    hfac, vfac = h0 // h1, v0 // v1
    cw, ch = -(-w * h1 // h0), -(-h * v1 // v0)
    mode = {(1, 1): YCC444, (2, 1): H2V1, (1, 2): H1V2,
            (2, 2): H2V2}.get((hfac, vfac), BOX)
    if mode in (H2V1, H2V2) and cw <= 2:
        mode = BOX
    return [0, 0, 0, w, h, cw, ch, mode, hfac, vfac]


# Upsampling modes (csrc/jpeg.cu Mode) and the metadata's columns.
GRAY, YCC444, H2V1, H2V2, H1V2, BOX = range(6)
_META = ("y_off", "cb_off", "cr_off", "w", "h", "cw", "ch", "mode", "hfac",
         "vfac")
_PLANE_ALIGN = 256


def decode_batch(datas: Sequence[bytes], device,
                 names: Optional[Sequence[str]] = None):
    """Decode JPEG files' bytes on ``device``.

    Returns (images [B, Hmax, Wmax, 3] uint8 on ``device``, sizes [B, 2]
    int64 numpy of (w, h)); image b fills the top-left corner of its slot
    and the rest of the slot is zero."""
    out, sizes, _ = _decode(datas, torch.device(device), names)
    return out, sizes


def _decode(datas, device: torch.device, names):
    """``decode_batch``, plus, on the card, (planes, meta): nvJPEG's
    planes and their metadata (``_META``), for ``plain_rgb``."""
    names = list(names) if names is not None else [
        f"<image {i}>" for i in range(len(datas))]
    infos = [jpeg_info(d, nm) for d, nm in zip(datas, names)]
    meta = np.asarray([_plane_meta(i, nm) for i, nm in zip(infos, names)],
                      np.int64).reshape(-1, len(_META))
    sizes = np.asarray([(i.width, i.height) for i in infos],
                       np.int64).reshape(-1, 2)
    hmax = int(sizes[:, 1].max()) if len(sizes) else 1
    wmax = int(sizes[:, 0].max()) if len(sizes) else 1
    out = torch.zeros((len(datas), hmax, wmax, 3), dtype=torch.uint8,
                      device=device)
    if device.type == "cuda":
        planes = _decode_cuda(datas, names, meta, out)
        decode_batch.images_by_route["nvjpeg"] += len(datas)
        return out, sizes, (planes, meta)
    for b, (data, name) in enumerate(zip(datas, names)):
        img = _pil_rgb(data, name)
        if img.shape[1::-1] != tuple(sizes[b]):
            raise JpegError(f"{name}: decoded size {img.shape[1::-1]} "
                            f"differs from the header's {tuple(sizes[b])}")
        out[b, :img.shape[0], :img.shape[1]] = torch.from_numpy(img)
    decode_batch.images_by_route["pil"] += len(datas)
    return out, sizes, None


# Images decoded on each route, and launches of the colour kernel.
decode_batch.images_by_route = {"nvjpeg": 0, "pil": 0}
decode_batch.launches = 0


def _decode_cuda(datas, names, meta: np.ndarray,
                 out: torch.Tensor) -> torch.Tensor:
    """nvJPEG into planes, the colour kernel into ``out``; returns the
    planes (uint8, on the card)."""
    n = len(datas)
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=out.device)
    w, h, cw, ch = (meta[:, _META.index(k)] for k in ("w", "h", "cw", "ch"))
    sizes = np.stack([w * h, cw * ch, cw * ch], 1)
    sizes = -(-sizes // _PLANE_ALIGN) * _PLANE_ALIGN
    offsets = np.cumsum(sizes.reshape(-1)) - sizes.reshape(-1)
    meta[:, :3] = offsets.reshape(n, 3)
    dev = out.device
    planes = torch.empty(int(sizes.sum()), dtype=torch.uint8, device=dev)
    host = torch.from_numpy(meta.copy()).pin_memory()
    meta_dev = host.to(dev, non_blocking=True)
    bufs = (ctypes.c_char_p * n)(*datas)
    lengths = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    failed = ctypes.c_int(-1)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = _lib().jpeg_decode(
            index, n, ctypes.cast(bufs, ctypes.c_void_p),
            ctypes.cast(lengths, ctypes.c_void_p), host.data_ptr(),
            meta_dev.data_ptr(), planes.data_ptr(), out.data_ptr(),
            out.stride(0), out.stride(1), out.shape[1], out.shape[2],
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(failed))
    if err:
        i = failed.value
        what = (f"CUDA error {err - 200}" if err >= 200
                else _NVJPEG_ERRORS.get(err, f"nvJPEG status {err}"))
        where = names[i] if 0 <= i < n else "a batch"
        raise JpegError(f"{where}: nvJPEG cannot decode it: {what}")
    decode_batch.launches += 1
    return planes


def decode(datas: Sequence[bytes], device,
           names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """The images of ``decode_batch`` as a list of [h, w, 3] uint8 views."""
    out, sizes = decode_batch(datas, device, names)
    return [out[b, :h, :w] for b, (w, h) in enumerate(sizes)]


def read_files(paths: Sequence[str]) -> List[bytes]:
    out = []
    for path in paths:
        with open(os.fspath(path), "rb") as f:
            out.append(f.read())
    return out


# ---------------------------------------------------------------------------
# the colour kernel's plain version
# ---------------------------------------------------------------------------

def plain_rgb(planes: torch.Tensor, meta: np.ndarray) -> List[torch.Tensor]:
    """The colour kernel's images, in torch, from nvJPEG's planes and their
    metadata (``_decode``): [h, w, 3] uint8 each."""
    out = []
    for m in meta.tolist():
        y_off, cb_off, cr_off, w, h, cw, ch, mode, hfac, vfac = m
        y = planes[y_off:y_off + w * h].view(h, w)
        cb = planes[cb_off:cb_off + cw * ch].view(ch, cw)
        cr = planes[cr_off:cr_off + cw * ch].view(ch, cw)
        out.append(ycc_to_rgb(y, cb, cr, mode, hfac, vfac))
    return out


def _upsample(p: torch.Tensor, w: int, h: int, mode: int, hfac: int,
              vfac: int) -> torch.Tensor:
    """libjpeg-turbo's upsampling of one chroma plane to [h, w] (int32)."""
    ch, cw = p.shape
    dev = p.device
    x = torch.arange(w, device=dev)
    y = torch.arange(h, device=dev)
    if mode == YCC444:
        return p[:h, :w]
    if mode == BOX:
        return p[(y // vfac)][:, x // hfac]
    if mode == H2V1:
        c = x >> 1
        left = p[:, (c - 1).clamp(min=0)]
        right = p[:, (c + 1).clamp(max=cw - 1)]
        here = p[:, c]
        even = torch.where(c == 0, here, (here * 3 + left + 1) >> 2)
        odd = torch.where(c == cw - 1, here, (here * 3 + right + 2) >> 2)
        return torch.where((x & 1) == 0, even, odd)
    r = y >> 1
    odd_row = (y & 1) == 1
    r1 = torch.where(odd_row, r + 1, r - 1).clamp(0, ch - 1)
    if mode == H1V2:
        bias = torch.where(odd_row, 2, 1)[:, None]
        return (p[r][:, x] * 3 + p[r1][:, x] + bias) >> 2
    sums = p[r] * 3 + p[r1]  # H2V2: [h, cw] column sums
    c = x >> 1
    here = sums[:, c]
    left = sums[:, (c - 1).clamp(min=0)]
    right = sums[:, (c + 1).clamp(max=cw - 1)]
    even = torch.where(c == 0, (here * 4 + 8) >> 4,
                       (here * 3 + left + 8) >> 4)
    odd = torch.where(c == cw - 1, (here * 4 + 7) >> 4,
                      (here * 3 + right + 7) >> 4)
    return torch.where((x & 1) == 0, even, odd)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               mode: int, hfac: int = 1, vfac: int = 1) -> torch.Tensor:
    """[h, w, 3] uint8 RGB from a luma plane [h, w] and chroma planes
    [ch, cw], as libjpeg-turbo upsamples and converts (jdsample.c,
    jdcolor.c); ``mode`` GRAY copies the luma into every channel."""
    h, w = y.shape
    yy = y.int()
    if mode == GRAY:
        return y[..., None].expand(h, w, 3).contiguous()
    cb, cr = (_upsample(p.int(), w, h, mode, hfac, vfac) - 128
              for p in (cb, cr))
    half = 1 << 15
    r = yy + ((91881 * cr + half) >> 16)
    g = yy + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = yy + ((116130 * cb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)
