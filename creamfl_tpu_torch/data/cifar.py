"""CIFAR-10/100 reader from the canonical python-pickle archives
(no torchvision dependency; reference `src/datasets/cifar.py`).

Port of the JAX package's ``data/cifar.py``. Expects the extracted
``cifar-100-python/`` or ``cifar-10-batches-py/`` directory under
``root``; raises FileNotFoundError otherwise. The uint8 ``[N, 32, 32, 3]``
array ``data`` is the image source: a sample carries its row
(``image_src``) and its recipe (``image_params``, ``data.transforms``)
instead of the image, and ``DeviceImages`` (``data/device_images.py``)
transforms a batch on the device, where the whole array lives.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from creamfl_tpu_torch.data.sample_rng import SampleRNG
from creamfl_tpu_torch.data.transforms import cifar_params


def _load_cifar100(root: str, train: bool):
    path = os.path.join(root, "cifar-100-python",
                        "train" if train else "test")
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    data = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data, np.asarray(d["fine_labels"], np.int64)


def _load_cifar10(root: str, train: bool):
    base = os.path.join(root, "cifar-10-batches-py")
    if train:
        parts = [f"data_batch_{i}" for i in range(1, 6)]
    else:
        parts = ["test_batch"]
    xs, ys = [], []
    for p in parts:
        with open(os.path.join(base, p), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        xs.append(d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.extend(d["labels"])
    return np.concatenate(xs), np.asarray(ys, np.int64)


class Cifar:
    """Samples {'image_src', 'image_params', 'labels'}: the client
    transforms' recipe (the reference client pipeline: 32 -> 281 upscale,
    rotation, a 256 crop and a flip at train time, plain normalize at
    test time)."""

    def __init__(self, root: str, name: str = "Cifar100",
                 train: bool = True, imgsize: int = 256,
                 indices: Optional[list] = None, seed: int = 2021):
        loader = _load_cifar100 if "100" in name else _load_cifar10
        self.data, self.targets = loader(root, train)
        self.train = train
        self.imgsize = imgsize
        if indices is not None:
            self.data = self.data[np.asarray(indices)]
            self.targets = self.targets[np.asarray(indices)]
        self.data = np.ascontiguousarray(self.data)
        self.rng = SampleRNG(seed)

    @property
    def out_size(self) -> int:
        """Side of the transformed images."""
        return self.imgsize if self.train else self.data.shape[2]

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, i: int):
        h, w = self.data.shape[1:3]
        params = cifar_params(w, h, self.train, self.rng.for_index(i),
                              self.imgsize)
        return {"image_src": np.int64(i), "image_params": params,
                "labels": np.int32(self.targets[i])}
