"""The port's JPEG layer (``data/jpeg.py``) against PIL.

* ``jpeg_size`` / ``read_size`` give PIL's size for every fixture JPEG;
* the CPU decode (PIL inside) equals PIL's ``convert("RGB")`` and pads
  each slot with zeros; grayscale comes out as three equal channels;
* a non-JPEG file and a CMYK file raise errors that name them;
* the colour kernel's plain version (``ycc_to_rgb``: libjpeg-turbo's fancy
  upsampling and its fixed-point YCbCr -> RGB) equals PIL's decode bit for
  bit, on files whose chroma planes are known (flat 32 x 16 blocks, so the
  planes are read off PIL's own YCbCr output) at 4:4:4, 4:2:2 and 4:2:0
  and odd sizes;
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
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(cmyk)
    with pytest.raises(jpeg.JpegError, match="cmyk.jpg.*CMYK"):
        jpeg.decode(jpeg.read_files([cmyk]), "cpu", [cmyk])
    assert jpeg.read_size(cmyk) == (16, 8)


@pytest.mark.parametrize("subsampling,mode", [
    (0, jpeg.YCC444), (1, jpeg.H2V1), (2, jpeg.H2V2)])
def test_plain_colour_conversion_equals_libjpeg(subsampling, mode):
    rng = np.random.default_rng(3 + subsampling)
    bw, bh = 32, 16
    for w, h in ((61, 45), (96, 64), (3, 7), (140, 41)):
        colours = rng.integers(0, 256, (-(-h // bh), -(-w // bw), 3),
                               dtype=np.uint8)
        img = np.repeat(np.repeat(colours, bh, 0), bw, 1)[:h, :w]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=95,
                                  subsampling=subsampling)
        data = buf.getvalue()
        meta = jpeg._plane_meta(jpeg.jpeg_info(data), "flat")
        cw, ch, got_mode, hfac, vfac = meta[5:]
        assert got_mode == (jpeg.BOX if mode != jpeg.YCC444 and cw <= 2
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
        got = jpeg.ycc_to_rgb(y, cb, cr, got_mode, hfac, vfac)
        np.testing.assert_array_equal(got.numpy(), rgb, err_msg=f"{w}x{h}")


def test_chip_smoke_decode_table_is_pils():
    names, datas = chip_smoke.decode_inputs()
    assert sorted(names) == sorted(chip_smoke.DECODE_TABLE)
    assert len(names) == 26
    for name, data in zip(names, datas):
        with Image.open(io.BytesIO(data)) as im:
            img = torch.from_numpy(np.asarray(im.convert("RGB")).copy())
        got = chip_smoke.decode_stats(img)
        np.testing.assert_allclose(got, chip_smoke.DECODE_TABLE[name],
                                   rtol=0, atol=6e-4, err_msg=name)
