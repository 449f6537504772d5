"""PNG and GIF files under a JPEG's name: the port's reader against PIL.

The JAX package opens every image with PIL, so a PNG or a GIF stored as
``.jpg`` is read there. The port reads it by its magic bytes
(``creamfl_tpu_torch/data/png_gif.py``, the pixel work in
``csrc/native.cpp``):

* PNG files of every colour type and bit depth, interlaced (Adam7) and not,
  their rows under all five filter types, written here by a small encoder
  of this file, and the files Pillow writes (also animated PNGs, with the
  default image the animation's first frame and outside it): each read
  bit-equal to PIL's ``convert("RGB")``;
* GIF files: Pillow's (global palette, interlaced and not, gray), one with
  its palette moved into the frame (local), one whose first frame lies
  inside a larger screen with and without a transparent index;
* sizes from the headers, a file of none of the three formats raising with
  its name;
* the real-data bundle with one fixture JPEG replaced by a PNG, or by an
  APNG whose default image is outside its animation, under its name, equal
  to the JAX package's bundle.

Tolerance: none (uint8, bit for bit).
"""

import functools
import io
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from creamfl_tpu_torch.data import jpeg, png_gif
from torch_cpu_share import torch_cpu_share  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _read(data: bytes, name: str = "x.jpg") -> np.ndarray:
    (img,) = jpeg.decode([data], "cpu", [name])
    return img.numpy()


# ---------------------------------------------------------------------------
# a PNG encoder with every filter type and Adam7
# ---------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_row(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples (flat) at ``depth`` bits, big-endian, MSB
    first."""
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    per = 8 // depth
    padded = np.zeros(-(-len(samples) // per) * per, np.int64)
    padded[:len(samples)] = samples
    shifts = (8 - depth * (np.arange(per) + 1))
    return (padded.reshape(-1, per) << shifts).sum(1).astype(
        np.uint8).tobytes()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows, bpp: int, first: int) -> bytes:
    """Each row under filter type (first + row index) % 5."""
    out, prev = [], None
    for y, row in enumerate(rows):
        cur = np.frombuffer(row, np.uint8).astype(np.int64)
        up = prev if prev is not None else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        kind = (first + y) % 5
        pred = [np.zeros_like(cur), left, up, (left + up) // 2,
                _paeth(left, up, upleft)][kind]
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _png(samples: np.ndarray, depth: int, color_type: int,
         interlace: bool = False, palette: bytes = b"",
         trns: bytes = b"") -> bytes:
    """A PNG of ``samples`` ([h, w, channels] ints) at ``depth`` bits."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw += _filter_rows([_pack_row(r.reshape(-1), depth) for r in sub],
                            bpp, first=i)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                       int(interlace))
    body = _chunk(b"IHDR", ihdr)
    if palette:
        body += _chunk(b"PLTE", palette)
    if trns:
        body += _chunk(b"tRNS", trns)
    return (png_gif.PNG_MAGIC + body + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


_LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
            (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("color_type,depth", _LAYOUTS,
                         ids=[f"ct{c}-{d}bit" for c, d in _LAYOUTS])
def test_png_layouts_equal_pil(color_type, depth, interlace):
    """Every colour type and bit depth, 13 x 11 pixels (ragged for Adam7
    and for sub-byte rows), gray at 16 bits with values on both sides of
    255; palettes with and without tRNS."""
    rng = np.random.default_rng(depth * 10 + color_type)
    h, w = 11, 13
    top = 1 << depth
    samples = rng.integers(0, top, (h, w, _CHANNELS[color_type]))
    if color_type == 0 and depth == 16:
        samples[::2] = rng.integers(0, 300, samples[::2].shape)
    palette = trns = b""
    if color_type == 3:
        n = min(top, 200)  # some indices past a short palette
        palette = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        trns = bytes(range(0, 256, 37)) if depth != 2 else b""
    data = _png(samples, depth, color_type, interlace, palette, trns)
    got = _read(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    assert jpeg.image_size(data) == (w, h)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGB", "RGBA",
                                  "I;16"])
def test_pillow_png_equal_pil(mode, tmp_path):
    """Files Pillow writes, under a ``.jpg`` name, read from disk."""
    rng = np.random.default_rng(3)
    base = Image.fromarray(rng.integers(0, 256, (19, 23, 4), np.uint8),
                           "RGBA")
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 600, (19, 23)).astype(
            np.uint16))
    elif mode in ("P", "PA"):
        img = base.convert("RGB").quantize(37)
        if mode == "PA":
            img.info["transparency"] = 5
    else:
        img = base.convert(mode)
    path = str(tmp_path / "photo.jpg")
    img.save(path, format="PNG")
    data = jpeg.read_files([path])[0]
    np.testing.assert_array_equal(_read(data, path), _pil_rgb(data))
    assert jpeg.read_size(path) == img.size


def test_animated_png_gives_frame_zero():
    rng = np.random.default_rng(4)
    frames = [Image.fromarray(rng.integers(0, 256, (9, 7, 3), np.uint8))
              for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="PNG", save_all=True,
                   append_images=frames[1:])
    data = buf.getvalue()
    assert b"acTL" in data
    np.testing.assert_array_equal(_read(data), _pil_rgb(data))
    np.testing.assert_array_equal(_read(data), np.asarray(frames[0]))
    # The first fcTL moved behind the frames: the IDAT image stands outside
    # the animation, and PIL still shows it.
    i = data.index(b"fcTL") - 4
    (length,) = struct.unpack(">I", data[i:i + 4])
    moved = data[:i] + data[i + 12 + length:]
    j = moved.index(b"IEND") - 4
    moved = moved[:j] + data[i:i + 12 + length] + moved[j:]
    np.testing.assert_array_equal(_read(moved, "late.jpg"), _pil_rgb(moved))
    np.testing.assert_array_equal(_read(moved, "late.jpg"),
                                  np.asarray(frames[0]))


def _apng_default_image(images) -> bytes:
    """Pillow's APNG whose default image (``images[0]``, the IDAT) is not
    part of the animation: its IDAT comes before the first fcTL."""
    buf = io.BytesIO()
    images[0].save(buf, format="PNG", save_all=True,
                   append_images=list(images[1:]), default_image=True)
    data = buf.getvalue()
    assert b"acTL" in data and data.index(b"IDAT") < data.index(b"fcTL")
    return data


def test_apng_default_image_equal_pil():
    frames = [Image.fromarray(np.full((9, 7, 3), v, np.uint8))
              for v in (10, 20, 30)]
    data = _apng_default_image(frames)
    np.testing.assert_array_equal(_read(data, "anim.jpg"), _pil_rgb(data))
    assert (_read(data, "anim.jpg") == 10).all()
    rng = np.random.default_rng(5)
    frames = [Image.fromarray(rng.integers(0, 256, (6, 11, 3), np.uint8))
              for _ in range(3)]
    data = _apng_default_image(frames)
    np.testing.assert_array_equal(_read(data), _pil_rgb(data))
    np.testing.assert_array_equal(_read(data), np.asarray(frames[0]))


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def _gif(size=(40, 27), colours=50, **save) -> bytes:
    rng = np.random.default_rng(size[0])
    img = Image.fromarray(rng.integers(0, 256, size[::-1] + (3,),
                                       np.uint8)).quantize(colours)
    buf = io.BytesIO()
    img.save(buf, format="GIF", **save)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["interlaced", "plain", "small", "gray",
                                  "transparent"])
def test_pillow_gif_equal_pil(case):
    """Global palettes: Pillow interlaces frames of 16 rows and more."""
    if case == "gray":
        img = Image.fromarray((np.arange(600).reshape(20, 30) % 256).astype(
            np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="GIF")
        data = buf.getvalue()
    else:
        size = (9, 7) if case == "small" else (40, 27)
        kw = {"interlace": False} if case == "plain" else {}
        if case == "transparent":
            kw["transparency"] = 3
        data = _gif(size, **kw)
    frame = png_gif.gif_frame(data)
    assert frame.interlaced == (case in ("interlaced", "gray",
                                         "transparent"))
    np.testing.assert_array_equal(_read(data), _pil_rgb(data))
    assert jpeg.image_size(data) == (frame.width, frame.height)


def test_gif_local_palette_equal_pil():
    """The global palette moved into the frame's descriptor."""
    data = bytearray(_gif((21, 18), colours=9))
    flags = data[10]
    n = 3 << ((flags & 7) + 1)
    palette = bytes(data[13:13 + n])
    desc = data.index(0x2C, 13 + n)
    head = bytes(data[:10]) + bytes([0, data[11], data[12]])
    rest = bytes(data[13 + n:desc + 9]) + bytes([data[desc + 9] | 0x80
                                                 | (flags & 7)])
    local = head + rest + palette + bytes(data[desc + 10:])
    assert not png_gif.gif_frame(bytes(local)).palette == b""
    np.testing.assert_array_equal(_read(bytes(local)),
                                  _pil_rgb(bytes(local)))
    np.testing.assert_array_equal(_read(bytes(local)),
                                  _pil_rgb(bytes(data)))


@pytest.mark.parametrize("transparency", [None, 3])
def test_gif_frame_inside_screen_equal_pil(transparency):
    """The first frame at (2, 1) of a larger screen: PIL fills the rest with
    the transparent index, or with index 0."""
    kw = {} if transparency is None else {"transparency": transparency}
    data = bytearray(_gif((8, 6), colours=16, **kw))
    n = 3 << ((data[10] & 7) + 1)
    desc = data.index(0x2C, 13 + n)
    data[6:10] = struct.pack("<HH", 12, 9)
    data[11] = 5  # a background index that PIL does not use
    data[desc + 1:desc + 5] = struct.pack("<HH", 2, 1)
    got = _read(bytes(data))
    assert got.shape == (9, 12, 3)
    np.testing.assert_array_equal(got, _pil_rgb(bytes(data)))


# ---------------------------------------------------------------------------
# dispatch, sizes, errors
# ---------------------------------------------------------------------------

def test_mixed_batch_and_routes():
    """A batch of a JPEG, a PNG and a GIF: each in its slot, the JPEG by
    PIL and the others by the native reader."""
    with open(os.path.join(FIX, "coco", "allimages",
                           "COCO_train2014_000000000001.jpg"), "rb") as f:
        jpg = f.read()
    png = _png(np.random.default_rng(0).integers(0, 256, (5, 70, 3)), 8, 2)
    gif = _gif((9, 7))
    before = dict(jpeg.decode_batch.images_by_route)
    buf, sizes = jpeg.decode_batch([png, jpg, gif], "cpu",
                                   ["a.jpg", "b.jpg", "c.jpg"])
    after = jpeg.decode_batch.images_by_route
    assert after["pil"] == before["pil"] + 1
    assert after["png_gif"] == before["png_gif"] + 2
    for b, data in enumerate((png, jpg, gif)):
        want = _pil_rgb(data)
        w, h = sizes[b]
        assert (h, w) == want.shape[:2]
        np.testing.assert_array_equal(buf[b, :h, :w].numpy(), want)
        assert not buf[b, h:].any() and not buf[b, :, w:].any()


def test_other_files_raise_with_their_names(tmp_path):
    path = str(tmp_path / "notes.jpg")
    with open(path, "wb") as f:
        f.write(b"BM not an image at all")
    with pytest.raises(jpeg.JpegError, match="notes.jpg.*JPEG, PNG or GIF"):
        jpeg.read_size(path)
    with pytest.raises(jpeg.JpegError, match="notes.jpg.*JPEG, PNG or GIF"):
        jpeg.decode(jpeg.read_files([path]), "cpu", [path])
    bad = bytearray(_png(np.zeros((4, 4, 3), np.int64), 8, 2))
    bad[25] = 5  # colour type 5 does not exist
    with pytest.raises(jpeg.JpegError, match="bad.jpg.*colour type"):
        _read(bytes(bad), "bad.jpg")


# ---------------------------------------------------------------------------
# the real-data bundle with a PNG under a JPEG's name
# ---------------------------------------------------------------------------

def test_bundle_with_png_equal_to_jax(tmp_path):
    """COCO's fixture images copied, one replaced by a PNG of its pixels
    under its own name; the public and test loaders of both packages'
    bundles over one epoch, every field equal."""
    def write(victim, rgb):
        rgb.save(victim, format="PNG")

    _bundle_equal_to_jax(tmp_path, write)


def test_bundle_with_apng_equal_to_jax(tmp_path):
    """As above with an APNG whose default image (the fixture's pixels)
    stands outside its animation."""
    def write(victim, rgb):
        others = [Image.new("RGB", rgb.size, (v, v, v)) for v in (40, 80)]
        with open(victim, "wb") as f:
            f.write(_apng_default_image([rgb] + others))

    _bundle_equal_to_jax(tmp_path, write)


def _bundle_equal_to_jax(tmp_path, write):
    from test_torch_real_data import ROOTS, _args, _partition_dir

    from creamfl_tpu.data import native as jnative
    from creamfl_tpu.data.pipelines import build_real_datasets as j_build
    from creamfl_tpu_torch.data import coco
    from creamfl_tpu_torch.data.pipelines import build_real_datasets

    roots = dict(ROOTS, coco_root=str(tmp_path / "coco"))
    shutil.copytree(ROOTS["coco_root"], roots["coco_root"])
    victim = os.path.join(roots["coco_root"], "allimages",
                          "COCO_train2014_000000000002.jpg")
    with Image.open(victim) as im:
        rgb = im.convert("RGB")
    write(victim, rgb)
    with open(victim, "rb") as f:
        assert f.read(8) == png_gif.PNG_MAGIC
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(coco, "CocoCaptionsCap",
                   functools.partial(coco.CocoCaptionsCap, native=False))
        jtmp, ttmp = tmp_path / "jax", tmp_path / "port"
        jax_ds = j_build(_args(jtmp), None,
                         partition_dir=_partition_dir(jtmp), **roots)
        port_ds = build_real_datasets(_args(ttmp), None,
                                      partition_dir=_partition_dir(ttmp),
                                      device="cpu", **roots)
    before = jpeg.decode_batch.images_by_route["png_gif"]
    for key in ("pub_train", "test"):
        jb, tb = list(jax_ds[key]), list(port_ds[key])
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for field in a:
                got = b[field]
                got = got.numpy() if isinstance(got, torch.Tensor) else got
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(a[field]),
                                              err_msg=f"{key}/{field}")
    assert jpeg.decode_batch.images_by_route["png_gif"] > before
