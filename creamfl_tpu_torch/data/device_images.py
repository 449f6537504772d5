"""The real-data path's device stage: a batch's image recipes -> images.

The real datasets (``data/coco.py``, ``data/flickr30k.py``,
``data/cifar.py``) return, per sample, the image's source key
(``image_src``) and its transform recipe (``image_params``), drawn on the
host from the same per-sample rng as the JAX package's PIL transforms.
``DeviceImages`` wraps a batch loader over such a dataset and turns each
batch's recipes into ``images``, a float32 NHWC tensor on the device,
equal bit for bit to the JAX package's for the same decoded pixels
(``data/transforms.py``):

* ``JpegFiles``: the batch's distinct image files are read once each and
  decoded together on the device (``data/jpeg.py``: nvJPEG on the card,
  PIL on the CPU); rows that share an image (a COCO image has five
  captions, and a padded batch repeats its rows) share its decode;
* ``ImageArray``: a uint8 ``[N, H, W, 3]`` array (CIFAR) that is moved to
  the device whole at the first batch and indexed there.

The recipe fields leave the batch; every other field passes through.
Decoding and transforming run on the consumer's thread, after any
``PrefetchLoader`` under ``base``: no device work is launched from a
prefetch thread. ``set_round`` passes through to ``base``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from creamfl_tpu_torch.data import jpeg
from creamfl_tpu_torch.data.loaders import outermost
from creamfl_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                               apply_batch, to_device)
from creamfl_tpu_torch.utils.device import resolve_device

RECIPE_FIELDS = ("image_src", "image_params")


class JpegFiles:
    """Image source over JPEG files: ``path_of(key) -> path``."""

    def __init__(self, path_of: Callable[[int], str]):
        self.path_of = path_of

    def fetch(self, keys: np.ndarray,
              device: torch.device) -> Tuple[torch.Tensor, np.ndarray]:
        """Per-row sources [B, Hmax, Wmax, 3] uint8 on ``device`` and their
        (w, h) [B, 2], each distinct file read and decoded once."""
        uniq, inverse = np.unique(np.asarray(keys, np.int64),
                                  return_inverse=True)
        inverse = inverse.reshape(-1)
        paths = [self.path_of(int(k)) for k in uniq]
        buf, sizes = jpeg.decode_batch(jpeg.read_files(paths), device, paths)
        return (buf.index_select(0, to_device(inverse.astype(np.int64),
                                              device)), sizes[inverse])


class ImageArray:
    """Image source over a uint8 [N, H, W, 3] host array, moved to the
    device whole at the first fetch."""

    def __init__(self, data: np.ndarray):
        self.data = data
        self._on = None

    def fetch(self, keys: np.ndarray,
              device: torch.device) -> Tuple[torch.Tensor, np.ndarray]:
        if self._on is None or self._on.device != device:
            self._on = torch.from_numpy(np.ascontiguousarray(
                self.data)).to(device)
        rows = to_device(np.asarray(keys, np.int64), device)
        h, w = self.data.shape[1:3]
        return (self._on.index_select(0, rows),
                np.tile(np.asarray([[w, h]], np.int64), (len(keys), 1)))


class DeviceImages:
    """Wrap a batch loader whose batches carry image recipes; attach
    ``images`` ([B, size, size, 3] float32 on ``device``, normalised with
    ``mean`` and ``std``)."""

    def __init__(self, base_loader, source, size: int, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD, device="cuda"):
        self.base = base_loader
        self.source = source
        self.size = size
        self.mean, self.std = mean, std
        self.device = resolve_device(device)

    def set_round(self, round_n: int) -> None:
        self.base.set_round(round_n)

    def skip_epoch(self) -> None:
        self.base.skip_epoch()

    def __len__(self) -> int:
        return len(self.base)

    def __iter__(self) -> Iterator[dict]:
        return outermost(self._batches())

    def _batches(self) -> Iterator[dict]:
        for batch in self.base:
            src, sizes = self.source.fetch(np.asarray(batch["image_src"]),
                                           self.device)
            out = {k: v for k, v in batch.items() if k not in RECIPE_FIELDS}
            out["images"] = apply_batch(src, sizes, batch["image_params"],
                                        self.size, self.mean, self.std)
            yield out
