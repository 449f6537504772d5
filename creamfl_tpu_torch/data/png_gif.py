"""PNG and GIF files: their size from the header, and their RGB pixels.

The JAX package opens every image with PIL (``data/coco.py``,
``data/flickr30k.py``), so a PNG or a GIF stored under a ``.jpg`` name is an
image there like any other. The port reads such files here, on the host, as
the JAX package decodes every image on the host; ``data/jpeg.py`` sends a
file here by its magic bytes, and the pixels then go through the same
device transforms as a decoded JPEG.

* PNG: the chunks are parsed here and ``zlib`` inflates the concatenated
  IDAT data; unfiltering, Adam7 de-interlacing and the expansion of every
  colour type and bit depth to RGB run in the port's C++ library
  (``csrc/native.cpp`` ``png_decode``). An animated PNG gives its default
  image, the IDAT one, as PIL's frame 0 does: whether that image is the
  animation's first frame (an ``fcTL`` before the IDAT) or stands outside
  the animation (the IDAT before the first ``fcTL``); the animation chunks
  (``acTL``, ``fcTL``, ``fdAT``) are skipped.
* GIF: the first frame, as PIL's ``convert("RGB")`` of a freshly opened
  file takes it: the screen filled with the frame's transparent index (or
  index 0), the frame's LZW codes (``csrc/native.cpp`` ``gif_decode``)
  through its local palette, or the global one.

Every image is ``uint8 [H, W, 3]``, equal bit for bit to PIL's
``Image.open(...).convert("RGB")``; alpha is dropped as that drops it. A
file these readers refuse raises ``JpegError`` with its name.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
GIF_MAGICS = (b"GIF87a", b"GIF89a")
_PNG_ERRORS = {1: "its image data is shorter than the image",
               2: "a row has an unknown filter type",
               3: "its colour type and bit depth are not PNG's"}
_GIF_ERRORS = {1: "its image data ends before the frame is whole",
               2: "its LZW data is corrupt",
               3: "its first frame lies outside the screen"}


def _error(name: str, what: str):
    from creamfl_tpu_torch.data.jpeg import JpegError

    return JpegError(f"{name}: {what}")


def image_format(data: bytes) -> Optional[str]:
    """"jpeg", "png" or "gif" by the file's magic bytes; None otherwise."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == PNG_MAGIC:
        return "png"
    if data[:6] in GIF_MAGICS:
        return "gif"
    return None


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

class PngInfo(NamedTuple):
    width: int
    height: int
    depth: int
    color_type: int
    interlace: int


def png_info(data: bytes, name: str = "<bytes>") -> PngInfo:
    """The IHDR chunk, which PNG puts first."""
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise _error(name, "a PNG file without its IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    return PngInfo(w, h, depth, ctype, interlace)


def _png_chunks(data: bytes, name: str):
    """(type, payload) of each chunk up to IEND."""
    i = len(PNG_MAGIC)
    while i + 8 <= len(data):
        (length,) = struct.unpack(">I", data[i:i + 4])
        kind = data[i + 4:i + 8]
        if i + 12 + length > len(data):
            raise _error(name, f"PNG chunk {kind!r} is cut short")
        yield kind, data[i + 8:i + 8 + length]
        if kind == b"IEND":
            return
        i += 12 + length
    raise _error(name, "a PNG file without its IEND chunk")


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """[H, W, 3] uint8, PIL's ``convert("RGB")`` of the file."""
    from creamfl_tpu_torch.data.native import _lib

    info = png_info(data, name)
    if info.interlace not in (0, 1):
        raise _error(name, f"PNG interlace method {info.interlace}")
    idat, palette = [], b""
    for kind, payload in _png_chunks(data, name):
        if kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            palette = payload
    if info.color_type == 3 and not palette:
        raise _error(name, "a palette PNG without its PLTE chunk")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise _error(name, f"its image data does not inflate ({e})") from e
    out = np.empty((info.height, info.width, 3), np.uint8)
    pal = np.frombuffer(palette or b"\0", np.uint8)
    err = _lib().png_decode(raw, len(raw), info.width, info.height,
                            info.depth, info.color_type, info.interlace,
                            pal.ctypes.data, len(palette) // 3,
                            out.ctypes.data)
    if err:
        raise _error(name, f"PNG: {_PNG_ERRORS.get(err, err)}")
    return out


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

class GifFrame(NamedTuple):
    """The screen's size and what the first frame needs to be drawn."""
    width: int
    height: int
    left: int
    top: int
    frame_width: int
    frame_height: int
    interlaced: bool
    palette: bytes
    transparency: int  # -1 without one
    min_code: int
    lzw: bytes


def gif_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(width, height) of the logical screen, PIL's size of the file."""
    if len(data) < 10:
        raise _error(name, "a GIF file cut short")
    return struct.unpack("<HH", data[6:10])


def _sub_blocks(data: bytes, i: int, name: str) -> Tuple[bytes, int]:
    """The payloads of the sub-blocks from byte i, and the byte after
    their terminator."""
    parts = []
    while True:
        if i >= len(data):
            raise _error(name, "a GIF block is cut short")
        n = data[i]
        if n == 0:
            return b"".join(parts), i + 1
        parts.append(data[i + 1:i + 1 + n])
        i += 1 + n


def gif_frame(data: bytes, name: str = "<bytes>") -> GifFrame:
    """Parse the screen descriptor and the blocks up to the first frame."""
    width, height = gif_size(data, name)
    flags = data[10]
    i = 13
    palette = b""
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette, i = data[i:i + n], i + n
    transparency = -1
    while i < len(data):
        block = data[i]
        if block == 0x21:  # extension
            label = data[i + 1] if i + 1 < len(data) else -1
            payload, nxt = _sub_blocks(data, i + 2, name)
            if label == 0xF9 and len(payload) >= 4 and payload[0] & 1:
                transparency = payload[3]
            i = nxt
        elif block == 0x2C:  # image descriptor
            if i + 11 > len(data):
                break
            left, top, fw, fh = struct.unpack("<HHHH", data[i + 1:i + 9])
            fflags = data[i + 9]
            i += 10
            if fflags & 0x80:
                n = 3 << ((fflags & 7) + 1)
                palette, i = data[i:i + n], i + n
            if not palette:
                raise _error(name, "a GIF frame without a palette")
            min_code = data[i]
            lzw, _ = _sub_blocks(data, i + 1, name)
            return GifFrame(width, height, left, top, fw, fh,
                            bool(fflags & 0x40), palette, transparency,
                            min_code, lzw)
        else:  # the trailer, or a byte that opens no block
            break
    raise _error(name, "a GIF file without an image")


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """[H, W, 3] uint8, PIL's ``convert("RGB")`` of the file's first
    frame."""
    from creamfl_tpu_torch.data.native import _lib

    f = gif_frame(data, name)
    out = np.empty((f.height, f.width, 3), np.uint8)
    pal = np.frombuffer(f.palette, np.uint8)
    lzw = f.lzw or b"\0"
    err = _lib().gif_decode(
        lzw, len(f.lzw), f.min_code, f.width, f.height, f.left, f.top,
        f.frame_width, f.frame_height, int(f.interlaced), pal.ctypes.data,
        len(f.palette) // 3, max(f.transparency, 0), out.ctypes.data)
    if err:
        raise _error(name, f"GIF: {_GIF_ERRORS.get(err, err)}")
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's or a GIF's RGB pixels."""
    kind = image_format(data)
    if kind == "png":
        return decode_png(data, name)
    if kind == "gif":
        return decode_gif(data, name)
    raise _error(name, "not a PNG or GIF file")


def size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(width, height) of a PNG or a GIF from its header."""
    if image_format(data) == "png":
        info = png_info(data, name)
        return info.width, info.height
    return tuple(gif_size(data, name))

