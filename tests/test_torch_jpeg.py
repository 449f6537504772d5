"""The port's JPEG layer (``data/jpeg.py``) against PIL.

* ``jpeg_size`` / ``read_size`` give PIL's size for every fixture JPEG;
* the CPU decode (PIL inside) equals PIL's ``convert("RGB")`` and pads
  each slot with zeros; grayscale comes out as three equal channels;
* a non-JPEG file and a file with fractional sampling factors raise errors
  that name them; a CMYK file decodes;
* the colour kernel's plain version (``plain_rgb``: libjpeg-turbo's fancy
  upsampling and its fixed-point YCbCr -> RGB) equals PIL's decode bit for
  bit, on files whose chroma planes are known (flat 32 x 16 blocks, so the
  planes are read off PIL's own YCbCr output) at 4:4:4, 4:2:2 and 4:2:0
  and odd sizes;
* the layouts beyond gray and YCbCr, made with PIL here (``_layout``):
  CMYK at 4:4:4, 4:2:2 and 4:2:0 (Pillow subsamples M, Y and K), YCCK (a
  CMYK file whose Adobe transform byte is set to 2: libjpeg then reads its
  components as Y, Cb, Cr, K; Pillow writes no YCCK itself) at 4:4:4 and
  4:2:0, and RGB-coded at 4:4:4 (``keep_rgb``; Pillow refuses to subsample
  it): the CPU decode and transform equal the JAX package's image bit for
  bit, and the colour kernel's plain version equals PIL's
  ``convert("RGB")`` bit for bit, its planes read off PIL's CMYK or RGB
  decode of the flat-block file;
* ``chip_smoke.py``'s decode table equals PIL's statistics of the same
  files (to its 3 decimals: within 6e-4), so that the table the card is
  held to cannot go stale.
"""

import base64
import glob
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from creamfl_tpu_torch.data import jpeg
from torch_cpu_share import torch_cpu_share  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FILES = sorted(glob.glob(os.path.join(FIX, "**", "*.jpg"), recursive=True))


def _extra(name):
    return base64.b64decode("".join(chip_smoke.EXTRA_JPEGS[name]))


def test_jpeg_size_matches_pil():
    assert len(FILES) == 30
    for path in FILES:
        with Image.open(path) as im:
            size = im.size
        with open(path, "rb") as f:
            assert jpeg.jpeg_size(f.read(), path) == size, path
        assert jpeg.read_size(path) == size, path
    for name in chip_smoke.EXTRA_JPEGS:
        data = _extra(name)
        with Image.open(io.BytesIO(data)) as im:
            assert jpeg.jpeg_size(data) == im.size


def test_cpu_decode_equals_pil():
    datas = jpeg.read_files(FILES) + [_extra(n) for n in
                                      chip_smoke.EXTRA_JPEGS]
    before = jpeg.decode_batch.images_by_route["pil"]
    buf, sizes = jpeg.decode_batch(datas, "cpu")
    assert jpeg.decode_batch.images_by_route["pil"] == before + len(datas)
    assert buf.dtype == torch.uint8 and buf.shape[0] == len(datas)
    for b, data in enumerate(datas):
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
        w, h = sizes[b]
        np.testing.assert_array_equal(buf[b, :h, :w].numpy(), want)
        assert not buf[b, h:].any() and not buf[b, :, w:].any()
    gray = jpeg.decode([_extra("gray")], "cpu")[0]
    assert torch.equal(gray[..., 0], gray[..., 1])
    assert torch.equal(gray[..., 0], gray[..., 2])


def test_bad_files_raise_with_their_names(tmp_path):
    not_jpeg = os.path.join(FIX, "coco_subset_idx")
    with pytest.raises(jpeg.JpegError, match="coco_subset_idx"):
        jpeg.decode(jpeg.read_files([not_jpeg]), "cpu", [not_jpeg])
    with pytest.raises(jpeg.JpegError, match="coco_subset_idx"):
        jpeg.read_size(not_jpeg)
    # Sampling factors 3:2:1 (libjpeg refuses them too): the frame header
    # of a 4:4:4 file patched.
    data = bytearray(_layout("ycc444", (16, 8)))
    sof = data.index(b"\xff\xc0")
    for c, fac in enumerate((0x31, 0x21, 0x11)):
        data[sof + 11 + 3 * c] = fac
    with pytest.raises(jpeg.JpegError, match="odd.jpg.*fractional"):
        jpeg.decode([bytes(data)], "cpu", ["odd.jpg"])
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(cmyk)
    assert jpeg.read_size(cmyk) == (16, 8)
    (img,) = jpeg.decode(jpeg.read_files([cmyk]), "cpu", [cmyk])
    with Image.open(cmyk) as im:
        np.testing.assert_array_equal(img.numpy(),
                                      np.asarray(im.convert("RGB")))


def _flat(rng, w, h, channels, bw=32, bh=16):
    """An image of flat bw x bh blocks (aligned to every MCU), so that the
    decoded planes are flat per block too."""
    colours = rng.integers(0, 256, (-(-h // bh), -(-w // bw), channels),
                           dtype=np.uint8)
    return np.repeat(np.repeat(colours, bh, 0), bw, 1)[:h, :w]


def _layout(name, size, seed=0):
    """A JPEG file's bytes of layout ``name``: "ycc<sub>", "cmyk<sub>",
    "ycck<sub>" or "rgb444", sub 444, 422 or 420, of flat blocks."""
    rng = np.random.default_rng(seed)
    w, h = size
    sub = {"444": 0, "422": 1, "420": 2}[name[-3:]]
    buf = io.BytesIO()
    if name.startswith("rgb"):
        Image.fromarray(_flat(rng, w, h, 3)).save(buf, "JPEG", quality=95,
                                                  keep_rgb=True)
    elif name.startswith("ycc") and not name.startswith("ycck"):
        Image.fromarray(_flat(rng, w, h, 3)).save(buf, "JPEG", quality=95,
                                                  subsampling=sub)
    else:
        Image.fromarray(_flat(rng, w, h, 4), "CMYK").save(
            buf, "JPEG", quality=95, subsampling=sub)
    data = bytearray(buf.getvalue())
    if name.startswith("ycck"):
        app14 = data.index(b"Adobe") - 4
        assert data[app14:app14 + 2] == b"\xff\xee"
        data[app14 + 15] = 2  # the transform byte: YCCK
    return bytes(data)


LAYOUTS = ("cmyk444", "cmyk422", "cmyk420", "ycck444", "ycck420", "rgb444")
SIZES = ((61, 45), (96, 64), (3, 7), (140, 41))


@pytest.mark.parametrize("subsampling,mode", [
    (0, jpeg.FULL), (1, jpeg.H2V1), (2, jpeg.H2V2)])
def test_plain_colour_conversion_equals_libjpeg(subsampling, mode):
    rng = np.random.default_rng(3 + subsampling)
    bw, bh = 32, 16
    for w, h in SIZES:
        img = _flat(rng, w, h, 3, bw, bh)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=95,
                                  subsampling=subsampling)
        data = buf.getvalue()
        assert jpeg.colour_space(jpeg.jpeg_info(data)) == jpeg.YCBCR
        meta = dict(zip(jpeg._META,
                        jpeg._plane_meta(jpeg.jpeg_info(data), "flat")))
        cw, ch, got_mode, hfac, vfac = (meta[f"{k}1"] for k in jpeg._COMP)
        assert meta["mode0"] == jpeg.FULL
        assert got_mode == (jpeg.BOX if mode != jpeg.FULL and cw <= 2
                            else mode)
        with Image.open(io.BytesIO(data)) as im:
            im.draft("YCbCr", im.size)
            ycc = np.asarray(im)
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.asarray(im.convert("RGB"))
        # Each chroma sample lies inside one flat block: read it at the
        # block's centre, where upsampling leaves it as it is.
        ys = np.minimum((np.arange(ch) * vfac // bh) * bh + bh // 2, h - 1)
        xs = np.minimum((np.arange(cw) * hfac // bw) * bw + bw // 2, w - 1)
        cb, cr = (torch.from_numpy(ycc[ys][:, xs, c].copy()) for c in (1, 2))
        y = torch.from_numpy(ycc[..., 0].copy())
        up = jpeg._upsample(cb.int(), w, h, got_mode, hfac, vfac)
        np.testing.assert_array_equal(up.numpy(), ycc[..., 1])
        comps = [y.int()] + [jpeg._upsample(p.int(), w, h, got_mode, hfac,
                                            vfac) for p in (cb, cr)]
        got = jpeg.to_rgb(jpeg.YCBCR, comps)
        np.testing.assert_array_equal(got.numpy(), rgb, err_msg=f"{w}x{h}")


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_cpu_decode_equals_jax(name):
    """The port's CPU path (PIL decode, torch transforms) against the JAX
    package's (PIL, ``imagenet_transform``) on each layout, train and eval
    draws: the same float32 images."""
    import random

    from creamfl_tpu.data.transforms import imagenet_transform
    from creamfl_tpu_torch.data import transforms as T

    for size in SIZES:
        data = _layout(name, size)
        assert jpeg.colour_space(jpeg.jpeg_info(data)) == {
            "c": jpeg.CMYK, "y": jpeg.YCCK, "r": jpeg.RGB}[name[0]]
        buf, sizes = jpeg.decode_batch([data], "cpu")
        for train in (True, False):
            with Image.open(io.BytesIO(data)) as im:
                want = imagenet_transform(im, train, random.Random(7),
                                          crop_size=16, resize_size=20)
            params = T.imagenet_params(*size, train, random.Random(7),
                                       crop_size=16, resize_size=20)
            got = T.apply_batch(buf, sizes, params[None], 16)[0]
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} {size} {train}")


def _pil_planes(name, meta, bw=32, bh=16):
    """The components' planes of a flat-block file, read off PIL's decode
    (CMYK: 255 - its Adobe-inverted values; RGB-coded: its RGB), each
    subsampled plane sampled at its blocks' centres, where upsampling
    leaves a value as it is; YCCK's planes are those of the CMYK file it
    was made from (the same coded data)."""
    src = _layout(name.replace("ycck", "cmyk"), (meta["w"], meta["h"]))
    with Image.open(io.BytesIO(src)) as im:
        pix = np.asarray(im).astype(np.int64)
        if im.mode == "CMYK":
            pix = 255 - pix
    h, w = pix.shape[:2]
    planes = []
    for c in range(meta["ncomp"]):
        cw, ch, mode, hfac, vfac = (meta[f"{k}{c}"] for k in jpeg._COMP)
        if mode == jpeg.FULL:
            plane = pix[..., c]
        else:
            ys = np.minimum((np.arange(ch) * vfac // bh) * bh + bh // 2,
                            h - 1)
            xs = np.minimum((np.arange(cw) * hfac // bw) * bw + bw // 2,
                            w - 1)
            plane = pix[ys][:, xs, c]
        planes.append(plane.astype(np.uint8).reshape(-1))
    return planes


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_plain_colour_equals_pil(name):
    for size in SIZES:
        data = _layout(name, size)
        row = jpeg._plane_meta(jpeg.jpeg_info(data), name)
        meta = dict(zip(jpeg._META, row))
        planes = _pil_planes(name, meta)
        row[:len(planes)] = np.cumsum([0] + [len(p) for p in planes]
                                      )[:-1].tolist()
        flat = torch.from_numpy(np.concatenate(planes))
        (got,) = jpeg.plain_rgb(flat, np.asarray([row], np.int64))
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{name} {size}")


def test_chip_smoke_decode_table_is_pils():
    names, datas = chip_smoke.decode_inputs()
    assert sorted(names) == sorted(chip_smoke.DECODE_TABLE)
    assert len(names) == 31
    for name, data in zip(names, datas):
        with Image.open(io.BytesIO(data)) as im:
            img = torch.from_numpy(np.asarray(im.convert("RGB")).copy())
        got = chip_smoke.decode_stats(img)
        np.testing.assert_allclose(got, chip_smoke.DECODE_TABLE[name],
                                   rtol=0, atol=6e-4, err_msg=name)
