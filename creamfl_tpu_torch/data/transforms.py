"""Image transforms of the real-data path, in two halves.

Port of the JAX package's ``data/transforms.py`` (reference
`src/datasets/_transforms.py` + `src/utils/load_datasets.py:236-274`, the
client CIFAR transforms of `ClientTrainer.py:230-235`). The JAX package
runs every transform through PIL on the host. Here the random draws stay
on the host and the pixel work runs in torch on the run's device:

* **Draws** (``imagenet_params``, ``cifar_params``): they consume the
  sample's ``random.Random`` exactly as the JAX package's
  ``imagenet_transform`` and ``cifar_client_transform`` do (the same
  calls in the same order) and return a recipe, a float64 vector laid out
  as ``PARAMS``. A draw needs only the source's ``(w, h)``: never its
  pixels, so a JPEG's header is enough.
* **Pixels** (``apply_batch``): uint8 HWC sources and their recipes in,
  the JAX package's float32 NHWC batch out. PIL's BILINEAR resample (the
  shorter-side resize and RandomResizedCrop's ``box=`` resize) is two
  passes of 22-bit integer weights, horizontal then vertical, each
  rounded to uint8; here each pass is a float64 product whose sums are
  integers below 2^53, so it is exact on any device and in any summation
  order. CIFAR's ``rotate`` is PIL's NEAREST affine walk in 16.16 fixed
  point, in int64. Normalisation keeps the JAX package's float32 order
  ``((x / 255) - mean) / std`` with tensor operands (a Python-scalar
  divisor becomes a reciprocal multiply on the card). So the batch equals
  the JAX package's bit for bit, on the CPU and on the card.

Train (ImageNet): RandomResizedCrop(224) + HFlip (+ const-mode
RandomErasing). Eval: Resize(256) + CenterCrop(224) (+ RandomErasing when
its probability is set, as in the reference). CIFAR train: Resize(281) +
Rotate(U(-10, 10), NEAREST, black fill) + RandomCrop(256) + HFlip; CIFAR
test: normalize at 32².
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# RGB stats from the reference's color_lib for Cifar100 clients.
CIFAR100_MEAN = np.array([0.5071, 0.4866, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)

# A recipe: resize the source's box (x0, y0, x1, y1) to (rw, rh); rotate
# the result by ``angle`` degrees about its centre (0: no rotation); crop
# the output square at (left, top); mirror it if ``flip``; after
# normalisation zero the erase box (e_h 0: none).
PARAMS = ("x0", "y0", "x1", "y1", "rw", "rh", "angle", "left", "top",
          "flip", "e_top", "e_left", "e_h", "e_w")
P = {name: i for i, name in enumerate(PARAMS)}

# PIL's 8-bit resample precision (libImaging/Resample.c).
_PRECISION_BITS = 22


# ---------------------------------------------------------------------------
# draws, on the host
# ---------------------------------------------------------------------------

def _shorter_side(w: int, h: int, size: int) -> Tuple[int, int]:
    """Size after ``Resize(size)`` (shorter side to ``size``)."""
    if w <= h:
        return size, max(1, round(h * size / w))
    return max(1, round(w * size / h)), size


def _center_offset(w: int, h: int, size: int) -> Tuple[int, int]:
    return int(round((w - size) / 2)), int(round((h - size) / 2))


def _recipe(**fields) -> np.ndarray:
    out = np.zeros(len(PARAMS), np.float64)
    for name, value in fields.items():
        out[P[name]] = value
    return out


def _erase_box(rng: random.Random, size: int, probability: float,
               min_area: float = 0.02, max_area: float = 1 / 3,
               min_aspect: float = 0.3):
    """The draws of the JAX package's ``random_erasing`` on a ``size`` x
    ``size`` output: (top, left, eh, ew), or None."""
    if rng.random() > probability:
        return None
    h = w = size
    area = h * w
    log_ar = (math.log(min_aspect), math.log(1 / min_aspect))
    for _ in range(10):
        target = rng.uniform(min_area, max_area) * area
        aspect = math.exp(rng.uniform(*log_ar))
        eh = int(round(math.sqrt(target * aspect)))
        ew = int(round(math.sqrt(target / aspect)))
        if ew < w and eh < h:
            top = rng.randint(0, h - eh)
            left = rng.randint(0, w - ew)
            return top, left, eh, ew
    return None


def imagenet_params(w: int, h: int, train: bool,
                    rng: Optional[random.Random] = None,
                    random_erasing_prob: float = 0.0, crop_size: int = 224,
                    resize_size: int = 256) -> np.ndarray:
    """The recipe ``imagenet_transform`` draws for a ``w`` x ``h`` source."""
    rng = rng or random
    if train:
        fields = None
        area = w * h
        scale, ratio = (0.08, 1.0), (3 / 4, 4 / 3)
        for _ in range(10):
            target_area = rng.uniform(*scale) * area
            log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = rng.randint(0, w - cw)
                top = rng.randint(0, h - ch)
                fields = dict(x0=left, y0=top, x1=left + cw, y1=top + ch,
                              rw=crop_size, rh=crop_size)
                break
        if fields is None:  # fallback: Resize(crop) + CenterCrop(crop)
            rw, rh = _shorter_side(w, h, crop_size)
            left, top = _center_offset(rw, rh, crop_size)
            fields = dict(x0=0, y0=0, x1=w, y1=h, rw=rw, rh=rh, left=left,
                          top=top)
        fields["flip"] = float(rng.random() < 0.5)
    else:
        rw, rh = _shorter_side(w, h, resize_size)
        left, top = _center_offset(rw, rh, crop_size)
        fields = dict(x0=0, y0=0, x1=w, y1=h, rw=rw, rh=rh, left=left,
                      top=top)
    # Not gated on train: the reference appends RandomErasing whenever its
    # probability is set (load_datasets.py:267-271).
    if random_erasing_prob > 0:
        box = _erase_box(rng, crop_size, random_erasing_prob)
        if box is not None:
            fields.update(e_top=box[0], e_left=box[1], e_h=box[2],
                          e_w=box[3])
    return _recipe(**fields)


def cifar_params(w: int, h: int, train: bool,
                 rng: Optional[random.Random] = None,
                 imgsize: int = 256) -> np.ndarray:
    """The recipe ``cifar_client_transform`` draws for a ``w`` x ``h``
    source (test: the source as it is)."""
    rng = rng or random
    if not train:
        return _recipe(x1=w, y1=h, rw=w, rh=h)
    rw, rh = _shorter_side(w, h, int(imgsize * 1.1))
    angle = rng.uniform(-10, 10)
    left = rng.randint(0, max(0, rw - imgsize))
    top = rng.randint(0, max(0, rh - imgsize))
    flip = float(rng.random() < 0.5)
    return _recipe(x1=w, y1=h, rw=rw, rh=rh, angle=angle, left=left, top=top,
                   flip=flip)


# ---------------------------------------------------------------------------
# PIL's arithmetic, on the host: resample weights and the rotation's map
# ---------------------------------------------------------------------------

def resize_coeffs(in_size, b0, b1, out_size, first, count: int,
                  reverse=None) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's BILINEAR resample weights along one axis, for a batch.

    Every argument but ``count`` is one value per image ([B]). Output ``j``
    of image ``b`` is output ``first[b] + j`` of a resize of source
    coordinates ``[b0, b1)`` of an axis of ``in_size`` pixels to
    ``out_size`` (outputs in reverse order when ``reverse[b]``). Returns
    the window starts [B, count] and the integer weights [B, count, K]
    (``precompute_coeffs`` and ``normalize_coeffs_8bpc`` of
    libImaging/Resample.c: the same double arithmetic in the same order,
    the window clipped to the image, not to the box). Outputs past
    ``out_size`` get no weight. Images with the same arguments (a CIFAR
    batch, same-sized eval sources) share one computation."""
    n = np.size(in_size)
    rev = np.zeros(n) if reverse is None else reverse
    rows = np.stack([np.asarray(v, np.float64).reshape(n) for v in (
        in_size, b0, b1, out_size, first, rev)], 1)
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    starts, weights = _resize_coeffs(*uniq.T, count)
    inverse = inverse.reshape(-1)
    return starts[inverse], weights[inverse]


def _resize_coeffs(in_size, b0, b1, out_size, first, reverse,
                   count: int) -> Tuple[np.ndarray, np.ndarray]:
    """``resize_coeffs`` for distinct argument rows."""
    as_col = lambda v: np.asarray(v, np.float64)[:, None]  # noqa: E731
    in_size, b0, b1, out_size = map(as_col, (in_size, b0, b1, out_size))
    # PIL passes the box as C floats.
    b0 = b0.astype(np.float32).astype(np.float64)
    b1 = b1.astype(np.float32).astype(np.float64)
    j = np.arange(count, dtype=np.float64)[None, :]
    rev = np.asarray(reverse, bool)[:, None]
    xx = as_col(first) + np.where(rev, count - 1 - j, j)
    live = (xx >= 0) & (xx < out_size)
    scale = (b1 - b0) / out_size
    filterscale = np.maximum(scale, 1.0)
    support = filterscale  # bilinear support 1.0
    ksize = int(np.max(np.ceil(support))) * 2 + 1
    ss = 1.0 / filterscale
    center = b0 + (xx + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0.0)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size) - xmin
    x = np.arange(ksize, dtype=np.float64)[None, None, :]
    t = np.abs(((x + xmin[..., None]) - center[..., None] + 0.5)
               * ss[..., None])
    k = np.where((x < xmax[..., None]) & (t < 1.0), 1.0 - t, 0.0)
    ww = np.zeros_like(center)
    for i in range(ksize):  # C's order: a running sum over the window
        ww = ww + k[..., i]
    k = np.where(ww[..., None] != 0.0, k / np.where(ww == 0.0, 1.0,
                                                    ww)[..., None], k)
    weights = np.trunc(0.5 + k * float(1 << _PRECISION_BITS))
    weights = np.where(live[..., None], weights, 0.0).astype(np.int64)
    return np.where(live, xmin, 0.0).astype(np.int64), weights


def rotate_fixed(angle: float, w: int, h: int) -> Tuple[int, ...]:
    """``Image.rotate(angle)``'s NEAREST map in 16.16 fixed point:
    (a0, a1, a2, a3, a4, a5) with source pixel
    ``((a2 + a1 * y + a0 * x) >> 16, (a5 + a4 * y + a3 * x) >> 16)`` for
    output pixel (x, y) (``affine_fixed`` of libImaging/Geometry.c, the
    matrix as ``Image.rotate`` builds it about (w/2, h/2))."""
    angle = angle % 360.0
    if angle == 0:
        m = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    else:
        cx, cy = w / 2, h / 2
        a = -math.radians(angle)
        m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
             round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]
        m[2] = m[0] * -cx + m[1] * -cy + m[2]
        m[5] = m[3] * -cx + m[4] * -cy + m[5]
        m[2] += cx
        m[5] += cy

    def fix(v: float) -> int:
        return math.floor(v * 65536.0 + 0.5)

    return (fix(m[0]), fix(m[1]), fix(m[2] + m[0] * 0.5 + m[1] * 0.5),
            fix(m[3]), fix(m[4]), fix(m[5] + m[3] * 0.5 + m[4] * 0.5))


# ---------------------------------------------------------------------------
# pixels, in torch on the sources' device
# ---------------------------------------------------------------------------

def _dense(starts: torch.Tensor, weights: torch.Tensor,
           n_in: int) -> torch.Tensor:
    """[B, R, n_in] float64 resample matrix from window starts and
    weights (zero weights past the window land on a clamped column)."""
    b, r, k = weights.shape
    idx = (starts[..., None] + torch.arange(k, device=starts.device)
           ).clamp_(max=n_in - 1)
    out = torch.zeros((b, r, n_in), dtype=torch.float64,
                      device=weights.device)
    return out.scatter_add_(2, idx, weights.double())


def _round_pass(acc: torch.Tensor) -> torch.Tensor:
    """PIL's ``clip8``: (acc + 2^21) >> 22, clipped to [0, 255]; exact on
    float64 integers."""
    half = float(1 << (_PRECISION_BITS - 1))
    return torch.floor((acc + half) * 2.0 ** -_PRECISION_BITS).clamp_(0, 255)


def _resample(src: torch.Tensor, wx: torch.Tensor,
              wy: torch.Tensor) -> torch.Tensor:
    """src [B, H, W, 3] uint8, wx [B, OW, W], wy [B, OH, H] -> [B, 3, OH,
    OW] float64 holding uint8 values: the horizontal pass, then the
    vertical one, each rounded as PIL rounds."""
    x = src.permute(0, 3, 1, 2).double()  # [B, 3, H, W]
    tmp = _round_pass(torch.matmul(x, wx.transpose(1, 2)[:, None]))
    return _round_pass(torch.matmul(wy[:, None], tmp))


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory and
    asynchronously (a pageable copy would wait for the queued work)."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def _pack(arrays: Sequence[np.ndarray], device) -> list:
    """Move int64 host arrays to ``device`` as one copy."""
    dev = to_device(np.concatenate([a.reshape(-1) for a in arrays]).astype(
        np.int64), device)
    out, at = [], 0
    for a in arrays:
        out.append(dev[at:at + a.size].view(a.shape))
        at += a.size
    return out


def apply_batch(src: torch.Tensor, sizes, params, size: int,
                mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Transform a batch on ``src``'s device.

    src: [B, Hmax, Wmax, 3] uint8, image ``b`` in its top-left
    ``sizes[b] = (w, h)`` corner; params: [B, len(PARAMS)] recipes; size:
    the output side. Returns [B, size, size, 3] float32, normalised with
    ``mean`` and ``std``. Without rotation the crop and the flip fold into
    the resample matrices (output columns and rows are independent); with
    it the sources are resized whole, then one gather rotates, crops and
    flips."""
    dev = src.device
    params = np.asarray(params, np.float64).reshape(-1, len(PARAMS))
    sizes = np.asarray(sizes, np.int64).reshape(-1, 2)
    b, hmax, wmax = src.shape[:3]
    assert len(params) == len(sizes) == b, (params.shape, sizes.shape, b)
    col = lambda name: params[:, P[name]]  # noqa: E731
    w, h = sizes[:, 0], sizes[:, 1]
    rw, rh = col("rw"), col("rh")
    flip = col("flip") > 0
    rotate = bool(np.any(col("angle") != 0))
    if rotate:
        nx, ny = int(rw.max()), int(rh.max())
        sx, kx = resize_coeffs(w, col("x0"), col("x1"), rw, np.zeros(b), nx)
        sy, ky = resize_coeffs(h, col("y0"), col("y1"), rh, np.zeros(b), ny)
        amap = np.asarray([rotate_fixed(a, int(x), int(y)) for a, x, y in
                           zip(col("angle"), rw, rh)], np.int64)
    else:
        sx, kx = resize_coeffs(w, col("x0"), col("x1"), rw, col("left"),
                               size, reverse=flip)
        sy, ky = resize_coeffs(h, col("y0"), col("y1"), rh, col("top"),
                               size)
        amap = np.zeros((b, 6), np.int64)
    boxes = np.stack([col("left"), col("top"), flip, rw, rh, col("e_top"),
                      col("e_left"), col("e_h"), col("e_w")], 1)
    sx, kx, sy, ky, amap, boxes = _pack(
        [sx, kx, sy, ky, amap, boxes.astype(np.int64)], dev)
    out = _resample(src, _dense(sx, kx, wmax), _dense(sy, ky, hmax))
    out = out.to(torch.uint8).permute(0, 2, 3, 1)  # NHWC
    if rotate:
        out = _rotate_crop_flip(out.contiguous(), amap, boxes, size)
    c255 = torch.full((), 255.0, dtype=torch.float32, device=dev)
    mean, std = (to_device(np.asarray(v, np.float32), dev)
                 for v in (mean, std))
    x = (out.float() / c255 - mean) / std
    if not np.any(col("e_h") > 0):  # decided on the host: no device sync
        return x
    return _erase(x, boxes[:, 5:9])


def _rotate_crop_flip(img: torch.Tensor, amap: torch.Tensor,
                      boxes: torch.Tensor, size: int) -> torch.Tensor:
    """img [B, NY, NX, 3] uint8 (image b in its top-left rw x rh corner) ->
    [B, size, size, 3]: PIL's NEAREST rotation (black outside the source),
    then the crop at (left, top), then the flip. The fixed-point map runs
    in int32: its terms stay below 2^31 for sides up to 8 000 pixels."""
    b, ny, nx, _ = img.shape
    dev = img.device
    left, top, flip, rw, rh = (boxes[:, i, None, None].int()
                               for i in range(5))
    ar = torch.arange(size, device=dev, dtype=torch.int32)
    xo = ar[None, None, :].expand(b, size, size)
    xo = torch.where(flip > 0, size - 1 - xo, xo) + left  # rotated image x
    yo = ar[None, :, None] + top  # rotated image y
    a = [amap[:, i, None, None].int() for i in range(6)]
    xin = (a[2] + a[1] * yo + a[0] * xo) >> 16
    yin = (a[5] + a[4] * yo + a[3] * xo) >> 16
    inside = (xin >= 0) & (xin < rw) & (yin >= 0) & (yin < rh)
    flat = torch.where(inside, yin * nx + xin, ny * nx)  # ny*nx: black
    src = torch.cat([img.reshape(b, ny * nx, 3), img.new_zeros((b, 1, 3))],
                    1)
    idx = flat.long().reshape(b, size * size, 1).expand(b, size * size, 3)
    return torch.gather(src, 1, idx).view(b, size, size, 3)


def _erase(x: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero each row's erase box (top, left, eh, ew) of [B, S, S, 3]."""
    s = x.shape[1]
    ar = torch.arange(s, device=x.device)
    top, left, eh, ew = (boxes[:, i, None] for i in range(4))
    rows = (ar[None] >= top) & (ar[None] < top + eh)
    cols = (ar[None] >= left) & (ar[None] < left + ew)
    mask = rows[:, :, None] & cols[:, None, :]
    return x.masked_fill(mask[..., None], 0.0)


# ---------------------------------------------------------------------------
# single images (the tests hold these against PIL)
# ---------------------------------------------------------------------------

def resize(img: torch.Tensor, size: Tuple[int, int],
           box: Optional[Sequence[float]] = None) -> torch.Tensor:
    """``Image.resize(size, BILINEAR, box=box)`` of a uint8 HWC tensor."""
    h, w = img.shape[:2]
    box = (0, 0, w, h) if box is None else box
    ow, oh = size
    sx, kx = resize_coeffs([w], [box[0]], [box[2]], [ow], [0], ow)
    sy, ky = resize_coeffs([h], [box[1]], [box[3]], [oh], [0], oh)
    sx, kx, sy, ky = (torch.from_numpy(a).to(img.device)
                      for a in (sx, kx, sy, ky))
    out = _resample(img[None], _dense(sx, kx, w), _dense(sy, ky, h))
    return out[0].permute(1, 2, 0).to(torch.uint8)


def rotate(img: torch.Tensor, angle: float) -> torch.Tensor:
    """``Image.rotate(angle)`` (NEAREST, same size, black fill) of a uint8
    HWC tensor."""
    h, w = img.shape[:2]
    amap = torch.tensor([rotate_fixed(angle, w, h)], device=img.device)
    boxes = torch.tensor([[0, 0, 0, w, h]], device=img.device)
    s = max(w, h)
    pad = img.new_zeros((1, s, s, 3))
    pad[0, :h, :w] = img
    return _rotate_crop_flip(pad, amap, boxes, s)[0, :h, :w]
