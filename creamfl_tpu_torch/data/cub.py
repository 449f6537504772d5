"""CUB-200-2011 caption dataset (reference `src/datasets/cub.py` +
`_dataloader.py:115-207`; dead code for CreamFL, ported for completeness).

Port of the JAX package's ``data/cub.py``. Layout expected under the
roots: ``images/<class_dir>/<img>.jpg`` and
``captions/<class_dir>/<img>.txt`` (one caption per line), with class
splits given as text files listing class dirs (the CVPR'17 zero-shot
splits). ``omit_ids`` removes seen test images from training.

As in the port's other real readers, a sample carries its image's recipe
instead of the image: ``image_src`` (the image's position in
``image_files``, whose file ``image_path`` names) and ``image_params``
(``data.transforms``), drawn from the image's size, read from its header,
with the JAX package's per-sample rng. ``DeviceImages``
(``data/device_images.py``) decodes and transforms a batch's images on the
device. Every other field equals the JAX package's, ``image_ids`` too:
``hash(rel) % 2**31``, as the JAX package computes it. Python salts string
hashes per process, so those ids agree with the JAX package's only within
one process (and differ in a worker process of ``data/grain_loaders.py``).
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from creamfl_tpu_torch.data.jpeg import read_size
from creamfl_tpu_torch.data.sample_rng import SampleRNG
from creamfl_tpu_torch.data.tokenize import caption_to_ids
from creamfl_tpu_torch.data.transforms import imagenet_params


def _read_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class CUBCaption:
    def __init__(self, image_root: str, caption_root: str,
                 classes_file: str, vocab=None, train: bool = False,
                 omit_ids: Optional[str] = None, max_len: int = 64,
                 seed: int = 2021):
        self.image_root = image_root
        self.train = train
        self.vocab = vocab
        self.max_len = max_len
        self.rng = SampleRNG(seed)
        omit = set(_read_lines(omit_ids)) if omit_ids else set()

        class_dirs = _read_lines(classes_file)
        self.samples = []  # (img_path, caption, class_idx)
        self.class_to_indices = {}
        self.image_files: List[str] = []  # distinct rel paths, image_src
        self._file_key = {}
        for cls_idx, cls in enumerate(sorted(class_dirs)):
            img_dir = os.path.join(image_root, cls)
            cap_dir = os.path.join(caption_root, cls)
            if not os.path.isdir(img_dir):
                continue
            for fname in sorted(os.listdir(img_dir)):
                rel = os.path.join(cls, fname)
                if rel in omit:
                    continue
                cap_file = os.path.join(
                    cap_dir, os.path.splitext(fname)[0] + ".txt")
                if not os.path.exists(cap_file):
                    continue
                for caption in _read_lines(cap_file):
                    if rel not in self._file_key:
                        self._file_key[rel] = len(self.image_files)
                        self.image_files.append(rel)
                    self.class_to_indices.setdefault(cls_idx, []).append(
                        len(self.samples))
                    self.samples.append((rel, caption, cls_idx))
        self.n_images = len({s[0] for s in self.samples})
        self.iid_to_cls = {i: s[2] for i, s in enumerate(self.samples)}
        self._sizes = {}

    def __len__(self):
        return len(self.samples)

    def image_path(self, key: int) -> str:
        return os.path.join(self.image_root, self.image_files[int(key)])

    def image_size(self, key: int) -> Tuple[int, int]:
        """(w, h) from the image's header, read once."""
        size = self._sizes.get(key)
        if size is None:
            size = self._sizes[key] = read_size(self.image_path(key))
        return size

    def __getitem__(self, index: int):
        rel, caption, cls_idx = self.samples[index]
        key = self._file_key[rel]
        w, h = self.image_size(key)
        params = imagenet_params(w, h, self.train, self.rng.for_index(index))
        ids = caption_to_ids(caption, self.vocab)[: self.max_len]
        tokens = np.zeros((self.max_len,), np.int32)
        tokens[: len(ids)] = ids
        return {
            "image_src": np.int64(key),
            "image_params": params,
            "captions": tokens,
            "lengths": np.int32(len(ids)),
            "ann_ids": np.int64(index),
            "image_ids": np.int64(hash(rel) % (2 ** 31)),
            "labels": np.int32(cls_idx),
            "index": np.int64(index),
        }


class CUBSampler:
    """Class-balanced sampling order: each epoch visits every class once
    with one random caption (reference CUBSampler semantics)."""

    def __init__(self, dataset: CUBCaption, seed: int = 0):
        self.dataset = dataset
        self.rng = random.Random(seed)

    def epoch_indices(self) -> Sequence[int]:
        out = []
        for cls, idxs in self.dataset.class_to_indices.items():
            out.append(self.rng.choice(idxs))
        self.rng.shuffle(out)
        return out
