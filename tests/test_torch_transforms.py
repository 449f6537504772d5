"""The port's image transforms vs the JAX package's PIL transforms.

Draws: from one ``random.Random`` seed, the port's recipes
(``imagenet_params``, ``cifar_params``) name the same PIL operations, with
the same arguments, that the JAX package's ``imagenet_transform`` and
``cifar_client_transform`` hand to PIL (captured by wrapping PIL's
methods), and the same erase box; afterwards both rngs are in the same
state. Pixels: the port's resample, rotation and whole transforms against
PIL on seeded random uint8 images of odd sizes. Tolerance: none (bit-equal
uint8 and float32).
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

from creamfl_tpu.data import transforms as jt
from creamfl_tpu_torch.data import transforms as tt
from torch_cpu_share import torch_cpu_share  # noqa: F401


class _Capture:
    """Record the PIL operations the JAX transforms make."""

    def __init__(self, monkeypatch):
        self.ops = []
        ops = self.ops
        resize, crop = Image.Image.resize, Image.Image.crop
        rotate, transpose = Image.Image.rotate, Image.Image.transpose

        def _resize(im, size, resample=None, box=None, **kw):
            ops.append(("resize", tuple(size),
                        None if box is None else tuple(box)))
            return resize(im, size, resample=resample, box=box, **kw)

        def _crop(im, box=None):
            ops.append(("crop", tuple(box)))
            return crop(im, box)

        def _rotate(im, angle, *a, **kw):
            ops.append(("rotate", angle))
            return rotate(im, angle, *a, **kw)

        def _transpose(im, method):
            ops.append(("flip", int(method)))
            return transpose(im, method)

        monkeypatch.setattr(Image.Image, "resize", _resize)
        monkeypatch.setattr(Image.Image, "crop", _crop)
        monkeypatch.setattr(Image.Image, "rotate", _rotate)
        monkeypatch.setattr(Image.Image, "transpose", _transpose)

    def take(self):
        out = list(self.ops)
        self.ops.clear()
        return out


def _from_ops(ops, w: int, h: int) -> dict:
    """The recipe fields that a list of captured PIL operations on a
    ``w`` x ``h`` source amounts to."""
    out = dict(x0=0, y0=0, x1=w, y1=h, rw=w, rh=h, angle=0, left=0, top=0,
               flip=0)
    for op in ops:
        if op[0] == "resize":
            out.update(rw=op[1][0], rh=op[1][1])
            if op[2] is not None:
                out.update(zip(("x0", "y0", "x1", "y1"), op[2]))
        elif op[0] == "rotate":
            out["angle"] = op[1]
        elif op[0] == "crop":
            out.update(left=op[1][0], top=op[1][1])
        else:
            assert op == ("flip", 0), op
            out["flip"] = 1
    return out


def _fields(p) -> dict:
    return {name: p[i] for i, name in enumerate(tt.PARAMS)
            if not name.startswith("e_")}


def _erase_mask(p, size: int) -> np.ndarray:
    g = {name: int(p[i]) for i, name in enumerate(tt.PARAMS)
         if name.startswith("e_")}
    mask = np.zeros((size, size), bool)
    mask[g["e_top"]:g["e_top"] + g["e_h"],
         g["e_left"]:g["e_left"] + g["e_w"]] = True
    return mask


# (w, h) sources: landscape, portrait, small, and a strip on which every
# RandomResizedCrop attempt fails (the center-crop fallback).
SIZES = [(640, 480), (333, 501), (57, 41), (500, 10)]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("erasing", [0.0, 0.5])
def test_imagenet_draws_match_pil_calls(monkeypatch, train, erasing):
    cap = _Capture(monkeypatch)
    fallbacks = erased = 0
    for seed in range(12):
        for w, h in SIZES:
            # A flat image whose normalised value is not 0 anywhere: the
            # JAX output's zeros are exactly its erase box.
            img = Image.new("RGB", (w, h), (200, 30, 90))
            r1, r2 = random.Random(seed), random.Random(seed)
            arr = jt.imagenet_transform(img, train, r1,
                                        random_erasing_prob=erasing)
            params = tt.imagenet_params(w, h, train, r2,
                                        random_erasing_prob=erasing)
            assert r1.getstate() == r2.getstate(), (seed, w, h)
            ops = cap.take()
            assert _from_ops(ops, w, h) == _fields(params), (seed, w, h, ops)
            fallbacks += train and ops[0][2] is None
            mask = _erase_mask(params, 224)
            np.testing.assert_array_equal((arr == 0).all(-1), mask)
            erased += bool(mask.any())
    if train:
        assert fallbacks >= 12  # every 500 x 10 draw
    assert (erased > 0) == (erasing > 0)


@pytest.mark.parametrize("train", [True, False])
def test_cifar_draws_match_pil_calls(monkeypatch, train):
    cap = _Capture(monkeypatch)
    img = np.full((32, 32, 3), 77, np.uint8)
    for seed in range(20):
        r1, r2 = random.Random(seed), random.Random(seed)
        jt.cifar_client_transform(img, train, r1)
        params = tt.cifar_params(32, 32, train, r2)
        assert r1.getstate() == r2.getstate()
        ops = cap.take()
        assert _from_ops(ops, 32, 32) == _fields(params), (seed, ops)


def _rand_image(rng, w, h):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_resize_and_box_resize_bit_equal_pil():
    rng = np.random.default_rng(0)
    for trial in range(24):
        w, h = (int(v) for v in rng.integers(5, 300, 2))
        img = _rand_image(rng, w, h)
        size = tuple(int(v) for v in rng.choice([1, 32, 57, 224, 281], 2))
        box = None
        if trial % 2:
            x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
            box = (x0, y0, int(rng.integers(x0 + 1, w + 1)),
                   int(rng.integers(y0 + 1, h + 1)))
        want = np.asarray(Image.fromarray(img).resize(
            size, resample=Image.BILINEAR, box=box))
        got = tt.resize(torch.from_numpy(img), size, box).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} {box}")


def test_rotate_bit_equal_pil():
    rng = np.random.default_rng(1)
    for trial in range(16):
        w, h = [(281, 281), (32, 32), (57, 44), (40, 71)][trial % 4]
        img = _rand_image(rng, w, h)
        angle = random.Random(trial).uniform(-10, 10)
        want = np.asarray(Image.fromarray(img).rotate(angle))
        got = tt.rotate(torch.from_numpy(img), angle).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{angle}")
    img = _rand_image(rng, 33, 33)
    np.testing.assert_array_equal(
        tt.rotate(torch.from_numpy(img), 0.0).numpy(), img)


def _padded(images):
    hm = max(i.shape[0] for i in images)
    wm = max(i.shape[1] for i in images)
    buf = torch.zeros((len(images), hm, wm, 3), dtype=torch.uint8)
    for b, img in enumerate(images):
        buf[b, :img.shape[0], :img.shape[1]] = torch.from_numpy(img)
    return buf, [(i.shape[1], i.shape[0]) for i in images]


@pytest.mark.parametrize("train", [True, False])
def test_imagenet_batch_bit_equal_jax(train):
    """Mixed source sizes in one padded batch, with erasing: the port's
    float32 batch equals the JAX package's images."""
    rng = np.random.default_rng(2)
    images = [_rand_image(rng, int(w), int(h))
              for w, h in rng.integers(30, 300, (9, 2))]
    images.append(_rand_image(rng, 400, 12))  # the fallback
    want = np.stack([jt.imagenet_transform(
        Image.fromarray(img), train, random.Random(i),
        random_erasing_prob=0.5) for i, img in enumerate(images)])
    params = np.stack([tt.imagenet_params(
        img.shape[1], img.shape[0], train, random.Random(i),
        random_erasing_prob=0.5) for i, img in enumerate(images)])
    buf, sizes = _padded(images)
    got = tt.apply_batch(buf, sizes, params, 224).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_cifar_batch_bit_equal_jax(train):
    rng = np.random.default_rng(3)
    images = [_rand_image(rng, 32, 32) for _ in range(8)]
    want = np.stack([jt.cifar_client_transform(img, train, random.Random(i))
                     for i, img in enumerate(images)])
    params = np.stack([tt.cifar_params(32, 32, train, random.Random(i))
                       for i in range(len(images))])
    got = tt.apply_batch(torch.from_numpy(np.stack(images)), [(32, 32)] * 8,
                         params, 256 if train else 32, tt.CIFAR100_MEAN,
                         tt.CIFAR100_STD).numpy()
    np.testing.assert_array_equal(got, want)
