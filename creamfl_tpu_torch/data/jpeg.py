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

Every image comes out as PIL's ``convert("RGB")`` gives it. The colour
space is the one libjpeg-turbo reads from the markers
(jdapimin.c:default_decompress_parms): gray; YCbCr; RGB-coded (an Adobe
marker with transform 0, or the component ids R, G, B without JFIF or
Adobe markers); CMYK and YCCK (4 components; PIL reads them as
Adobe-inverted CMYK, and YCCK is turned into CMYK as libjpeg does first).
Each component is upsampled from its own sampling factors.

A file is read by its magic bytes, whatever its name: a PNG or a GIF (as
the JAX package's PIL reads them under a ``.jpg`` name) is decoded on the
host by ``data/png_gif.py``, on either device, and lands in its slot like a
JPEG; a JPEG never takes that path. A file that no reader can read (none of
JPEG, PNG or GIF, 2 JPEG components, fractional sampling, a size that
differs from its header's) raises an error that names it.
``decode_batch.images_by_route`` counts the images decoded by ``"nvjpeg"``,
by ``"pil"`` and by ``"png_gif"`` (PNG and GIF, on the host).
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

from creamfl_tpu_torch.data import png_gif
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
    """What the markers say: the size, the components' sampling factors
    (h, v) and ids, the Adobe colour transform (-1 without APP14) and
    whether a JFIF marker (APP0) came before the frame header."""
    width: int
    height: int
    factors: Tuple[Tuple[int, int], ...]
    component_ids: Tuple[int, ...]
    adobe_transform: int
    jfif: bool = False


def jpeg_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(width, height) from the frame header of a JPEG file's bytes."""
    info = jpeg_info(data, name)
    return info.width, info.height


def jpeg_info(data: bytes, name: str = "<bytes>") -> JpegInfo:
    """Parse the markers up to the frame header (SOF)."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError(f"{name}: not a JPEG file (no SOI marker)")
    i, n = 2, len(data)
    adobe, jfif = -1, False
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
        # As libjpeg-turbo's jdmarker.c:get_interesting_appn: APP0 of at
        # least 14 data bytes opening with "JFIF\0", APP14 of at least 12
        # opening with "Adobe" (the transform is its 12th byte).
        if marker == 0xE0 and data[i + 2:i + 7] == b"JFIF\0" \
                and length >= 16:
            jfif = True
        if marker == 0xEE and data[i + 2:i + 7] == b"Adobe" and length >= 14:
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
                            tuple(c[0] for c in comps), adobe, jfif)
        if marker == 0xDA:  # start of scan before any frame header
            break
        i += length
    raise JpegError(f"{name}: no frame header (SOF) found")


def image_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(width, height) of a JPEG, PNG or GIF file's bytes, from its
    header."""
    kind = png_gif.image_format(data)
    if kind in ("png", "gif"):
        return png_gif.size(data, name)
    if kind is None:
        raise JpegError(f"{name}: not a JPEG, PNG or GIF file")
    return jpeg_size(data, name)


def read_size(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG, PNG or GIF file, reading its header
    only."""
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
        try:
            return image_size(head, path)
        except JpegError:
            if len(head) < HEADER_BYTES:
                raise
            return image_size(head + f.read(), path)


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


def colour_space(info: JpegInfo, name: str = "<bytes>") -> int:
    """The colour space libjpeg-turbo reads from the markers
    (jdapimin.c:default_decompress_parms)."""
    n = len(info.factors)
    if n == 1:
        return GRAY
    if n == 3:
        if info.jfif:
            return YCBCR
        if info.adobe_transform >= 0:
            return RGB if info.adobe_transform == 0 else YCBCR
        return RGB if info.component_ids == (82, 71, 66) else YCBCR
    if n == 4:
        return YCCK if info.adobe_transform > 0 else CMYK
    raise JpegError(f"{name}: {n} colour components; JPEG files have 1, 3 "
                    "or 4")


def _plane_meta(info: JpegInfo, name: str) -> List[int]:
    """The image's row of ``_META``, with the plane offsets 0: its size, its
    colour space, and per component its plane's size and the upsampling
    libjpeg-turbo picks for it (jdsample.c:jinit_upsampler, with its
    default fancy upsampling)."""
    w, h, f = info.width, info.height, info.factors
    if w < 1 or h < 1 or any(not 1 <= x <= 4 for fac in f for x in fac):
        raise JpegError(f"{name}: bad frame header (size {w} x {h}, "
                        f"sampling factors {f})")
    colour = colour_space(info, name)
    hmax, vmax = max(a for a, _ in f), max(b for _, b in f)
    comps = []
    for hc, vc in f:
        if hmax % hc or vmax % vc:
            raise JpegError(f"{name}: sampling factors {f} are fractional "
                            "(libjpeg refuses them too)")
        hfac, vfac = hmax // hc, vmax // vc
        cw, ch = -(-w * hc // hmax), -(-h * vc // vmax)
        mode = {(1, 1): FULL, (2, 1): H2V1, (1, 2): H1V2,
                (2, 2): H2V2}.get((hfac, vfac), BOX)
        if mode in (H2V1, H2V2) and cw <= 2:
            mode = BOX
        comps += [cw, ch, mode, hfac, vfac]
    comps += [0] * (_COMP_LEN * _MAX_COMPONENTS - len(comps))
    return [0] * _MAX_COMPONENTS + [w, h, colour, len(f)] + comps


# Upsampling of one component (csrc/jpeg.cu Mode): at the image's size, the
# fancy triangle filters, or replication.
FULL, H2V1, H2V2, H1V2, BOX = range(5)
# Colour spaces (csrc/jpeg.cu Colour).
GRAY, YCBCR, RGB, CMYK, YCCK = range(5)
# The metadata's columns: the planes' offsets, the image's size, colour
# space and component count, then per component its plane's size and its
# upsampling.
_MAX_COMPONENTS = 4
_COMP = ("cw", "ch", "mode", "hfac", "vfac")
_COMP_LEN = len(_COMP)
_META = (tuple(f"off{c}" for c in range(_MAX_COMPONENTS))
         + ("w", "h", "colour", "ncomp")
         + tuple(f"{k}{c}" for c in range(_MAX_COMPONENTS) for k in _COMP))
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
    planes and their metadata (``_META``), for ``plain_rgb``, of the
    batch's JPEG files."""
    names = list(names) if names is not None else [
        f"<image {i}>" for i in range(len(datas))]
    kinds = [png_gif.image_format(d) for d in datas]
    for kind, name in zip(kinds, names):
        if kind is None:
            raise JpegError(f"{name}: not a JPEG, PNG or GIF file")
    if any(kind != "jpeg" for kind in kinds):
        return _decode_mixed(datas, device, names, kinds)
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


def _decode_mixed(datas, device: torch.device, names, kinds):
    """``_decode`` of a batch that holds PNG or GIF files: those decoded on
    the host (``png_gif``) and copied into their slots, the JPEG files
    decoded together as a batch of their own and copied into theirs."""
    images = {b: png_gif.decode(d, nm) for b, (d, nm, kind)
              in enumerate(zip(datas, names, kinds)) if kind != "jpeg"}
    jpegs = [b for b, kind in enumerate(kinds) if kind == "jpeg"]
    sizes = np.zeros((len(datas), 2), np.int64)
    for b, img in images.items():
        sizes[b] = img.shape[1], img.shape[0]
    planes = None
    if jpegs:
        sub, sizes[jpegs], planes = _decode(
            [datas[b] for b in jpegs], device, [names[b] for b in jpegs])
    out = torch.zeros((len(datas), int(sizes[:, 1].max()),
                       int(sizes[:, 0].max()), 3), dtype=torch.uint8,
                      device=device)
    if jpegs:
        out[jpegs, :sub.shape[1], :sub.shape[2]] = sub
    for b, img in images.items():
        out[b, :img.shape[0], :img.shape[1]] = torch.from_numpy(img).to(
            device)
    decode_batch.images_by_route["png_gif"] += len(images)
    return out, sizes, planes


# Images decoded on each route, and launches of the colour kernel.
decode_batch.images_by_route = {"nvjpeg": 0, "pil": 0, "png_gif": 0}
decode_batch.launches = 0


def _decode_cuda(datas, names, meta: np.ndarray,
                 out: torch.Tensor) -> torch.Tensor:
    """nvJPEG into planes, the colour kernel into ``out``; returns the
    planes (uint8, on the card)."""
    n = len(datas)
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=out.device)
    sizes = np.stack([meta[:, _META.index(f"cw{c}")]
                      * meta[:, _META.index(f"ch{c}")]
                      for c in range(_MAX_COMPONENTS)], 1)
    sizes = -(-sizes // _PLANE_ALIGN) * _PLANE_ALIGN
    offsets = np.cumsum(sizes.reshape(-1)) - sizes.reshape(-1)
    meta[:, :_MAX_COMPONENTS] = offsets.reshape(n, _MAX_COMPONENTS)
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
        row = dict(zip(_META, m))
        w, h = row["w"], row["h"]
        comps = []
        for c in range(row["ncomp"]):
            cw, ch, mode, hfac, vfac = (row[f"{k}{c}"] for k in _COMP)
            off = row[f"off{c}"]
            plane = planes[off:off + cw * ch].view(ch, cw)
            comps.append(_upsample(plane.int(), w, h, mode, hfac, vfac))
        out.append(to_rgb(row["colour"], comps))
    return out


def _upsample(p: torch.Tensor, w: int, h: int, mode: int, hfac: int,
              vfac: int) -> torch.Tensor:
    """libjpeg-turbo's upsampling of one component's plane to [h, w]
    (int32)."""
    ch, cw = p.shape
    dev = p.device
    x = torch.arange(w, device=dev)
    y = torch.arange(h, device=dev)
    if mode == FULL:
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


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
               ) -> torch.Tensor:
    """[h, w, 3] int32 RGB in [0, 255] from upsampled Y, Cb, Cr planes
    (int32), as libjpeg-turbo's jdcolor.c converts (16-bit fixed point,
    arithmetic right shifts)."""
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255)


def _muldiv255(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PIL's MULDIV255: round(a * b / 255) in integers."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def to_rgb(colour: int, comps: Sequence[torch.Tensor]) -> torch.Tensor:
    """[h, w, 3] uint8 from a colour space's upsampled components (int32
    [h, w] each), as PIL's ``convert("RGB")`` of libjpeg's output gives
    it. CMYK: PIL reads Adobe-inverted ink (255 - c) and
    ``cmyk2rgb`` gives nk - nk * ink / 255 with nk = 255 - K, that is
    c3 - c3 * (255 - c) / 255 from the stored values; YCCK: libjpeg's
    ycck_cmyk_convert (255 minus the YCbCr -> RGB of the first three)
    first, so the ink PIL reads is that RGB."""
    if colour == GRAY:
        rgb = comps[0][..., None].expand(*comps[0].shape, 3)
    elif colour == YCBCR:
        rgb = ycc_to_rgb(*comps)
    elif colour == RGB:
        rgb = torch.stack(comps, -1)
    else:
        k = comps[3][..., None]
        ink = (255 - torch.stack(comps[:3], -1) if colour == CMYK
               else ycc_to_rgb(*comps[:3]))
        rgb = k - _muldiv255(ink, k)
    return rgb.clamp(0, 255).to(torch.uint8).contiguous()
