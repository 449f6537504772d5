"""Flickr30k caption dataset for multimodal clients
(reference `src/datasets/flickr30k.py`).

Port of the JAX package's ``data/flickr30k.py``. The reference consumes a
pickled Karpathy-style split (``dataset_k_split.pkl``) that is missing
from its repository; as in the JAX package, the public Karpathy
``dataset_flickr30k.json`` (images with per-image sentence lists and a
train/val/test split field) is read instead and the same structure
regenerated. The committed non-IID shard partition
(``client_noniid_flicker30k.pkl``: 15 clients x ~9660 caption indices) is
honoured when present, and a regenerated one is written back.

A sample carries its image's recipe (``image_src``, the image id whose
file ``image_path`` names, and ``image_params``) instead of the image, as
in ``data/coco.py``; ``DeviceImages`` makes the images on the device.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

from creamfl_tpu_torch.data.jpeg import read_size
from creamfl_tpu_torch.data.sample_rng import SampleRNG
from creamfl_tpu_torch.data.tokenize import caption_to_ids
from creamfl_tpu_torch.data.transforms import imagenet_params


class F30kCaptionsCap:
    def __init__(self, root: str, split: str = "train", train: bool = True,
                 vocab=None, max_len: int = 64,
                 caption_drop_prob: float = 0.0,
                 random_erasing_prob: float = 0.0,
                 client: int = -1,
                 partition_pickle: Optional[str] = None,
                 seed: int = 2021):
        """root must contain dataset_flickr30k.json + flickr30k-images/."""
        ann = os.path.join(root, "dataset_flickr30k.json")
        with open(ann) as f:
            data = json.load(f)
        self.image_root = os.path.join(root, "flickr30k-images")
        self.train = train
        self.vocab = vocab
        self.max_len = max_len
        self.caption_drop_prob = caption_drop_prob if train else 0.0
        self.random_erasing_prob = random_erasing_prob if train else 0.0
        self.rng = SampleRNG(seed)

        pairs = []  # (filename, caption, image_id, ann_id)
        files = {}
        ann_id = 0
        for im in data["images"]:
            im_split = im.get("split", "train")
            if split == "train" and im_split in ("train", "restval"):
                keep = True
            else:
                keep = im_split == split
            if not keep:
                continue
            files[im["imgid"]] = im["filename"]
            for sent in im["sentences"]:
                pairs.append((im["filename"], sent["raw"], im["imgid"],
                              ann_id))
                ann_id += 1
        self.pairs = pairs
        self._files = files
        self._sizes = {}

        if client > -1:
            shard = self._client_indices(client, partition_pickle)
            self.pairs = [pairs[i] for i in shard if i < len(pairs)]

        self.n_images = len({p[2] for p in self.pairs})
        self.iid_to_cls = None

    def _client_indices(self, client: int,
                        partition_pickle: Optional[str]) -> Sequence[int]:
        if partition_pickle and os.path.exists(partition_pickle):
            with open(partition_pickle, "rb") as f:
                mapping = pickle.load(f)
            return mapping[client]
        mapping = self._regenerate_partition(len(self.pairs))
        if partition_pickle:
            # The reference writes the regenerated mapping back
            # (flickr30k.py:102) so every client reads ONE draw. Create the
            # partition dir if absent: a FileNotFoundError here would be
            # misread by build_datasets as missing data roots.
            parent = os.path.dirname(partition_pickle)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(partition_pickle, "wb") as f:
                pickle.dump(mapping, f)
        return mapping[client]

    @staticmethod
    def _regenerate_partition(n: int, n_users: int = 15,
                              n_shards: int = 150):
        """Reference non-IID scheme (flickr30k.py:79-103): each user draws
        ``n_shards/n_users`` shards via np.random.choice without
        replacement; the ``n % n_shards`` leftover pairs concatenate onto
        the LAST user (the reference's leaked loop variable)."""
        shard_size = n // n_shards
        idx_shard = list(range(n_shards))
        idxs = np.arange(n_shards * shard_size)
        users = {}
        for i in range(n_users):
            rand_set = set(np.random.choice(
                idx_shard, n_shards // n_users, replace=False))
            idx_shard = list(set(idx_shard) - rand_set)
            arr = np.array([], dtype=int)
            for rand in rand_set:
                arr = np.concatenate(
                    (arr, idxs[rand * shard_size:(rand + 1) * shard_size]))
            users[i] = arr
        leftover = np.arange(n_shards * shard_size, n)
        users[n_users - 1] = np.concatenate([users[n_users - 1], leftover])
        return users

    def __len__(self):
        return len(self.pairs)

    def image_path(self, image_id: int) -> str:
        return os.path.join(self.image_root, self._files[int(image_id)])

    def image_size(self, image_id: int) -> Tuple[int, int]:
        """(w, h) from the image's JPEG header, read once."""
        size = self._sizes.get(image_id)
        if size is None:
            size = self._sizes[image_id] = read_size(
                self.image_path(image_id))
        return size

    def __getitem__(self, index: int):
        _, caption, image_id, ann_id = self.pairs[index]
        rng = self.rng.for_index(index)
        w, h = self.image_size(image_id)
        params = imagenet_params(w, h, self.train, rng,
                                 random_erasing_prob=self.random_erasing_prob)
        ids = caption_to_ids(caption, self.vocab, self.caption_drop_prob,
                             rng)[: self.max_len]
        tokens = np.zeros((self.max_len,), np.int32)
        tokens[: len(ids)] = ids
        return {
            "image_src": np.int64(image_id),
            "image_params": params,
            "captions": tokens,
            "lengths": np.int32(len(ids)),
            "ann_ids": np.int64(ann_id),
            "image_ids": np.int64(image_id),
            "index": np.int64(index),
        }
