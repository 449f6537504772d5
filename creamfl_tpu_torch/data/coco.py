"""MS-COCO caption dataset (reference `src/datasets/coco.py:30-148`).

Port of the JAX package's ``data/coco.py``. Parses
``captions_train2014.json`` (plus an optional extra annotation file for
the restval ids) without pycocotools, indexes by caption (annotation) id,
and returns the reference's per-sample caption fields. The frozen 50k
public subset (``coco_subset_idx_file``, a pickled sorted index list into
the 566 435-caption train+restval set) is honoured verbatim when present.

Where the JAX package returns the transformed image, a sample here
carries its recipe: ``image_src`` (the image id, whose file
``image_path`` names) and ``image_params`` (``data.transforms``), drawn
from the source's size, read from its JPEG header. ``DeviceImages``
(``data/device_images.py``) decodes and transforms a batch's images on
the device. The draws run first and then the caption drop, from the same
per-sample rng, in the JAX package's order. Captions go through the native
tokenizer (``data/native.py``, built with g++ at first use), as the JAX
package's do once its native library is built: with caption drops, its
``mt19937_64`` is seeded by ``rng.getrandbits(63)``. ``native=False``
takes the Python tokenizer (``caption_to_ids``) instead, the JAX
package's path without its library.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from creamfl_tpu_torch.data.jpeg import read_size
from creamfl_tpu_torch.data.sample_rng import SampleRNG
from creamfl_tpu_torch.data.tokenize import caption_to_ids
from creamfl_tpu_torch.data.transforms import imagenet_params


def _load_annotations(ann_path: str):
    with open(ann_path) as f:
        data = json.load(f)
    imgs = {im["id"]: im["file_name"] for im in data["images"]}
    anns = {a["id"]: a for a in data["annotations"]}
    return imgs, anns


class CocoCaptionsCap:
    """Caption-indexed COCO. ``ids``/``extra_ids`` select annotation ids
    from the primary/extra annotation files respectively."""

    def __init__(self, image_root: str, ann_path: str,
                 ids: Optional[Sequence[int]] = None,
                 extra_ann_path: Optional[str] = None,
                 extra_ids: Optional[Sequence[int]] = None,
                 train: bool = False,
                 vocab=None,
                 max_len: int = 64,
                 caption_drop_prob: float = 0.0,
                 random_erasing_prob: float = 0.0,
                 bert_tokenizer=None,
                 bert_max_len: int = 64,
                 seed: int = 2021,
                 allow_missing_ids: bool = False,
                 native: bool = True):
        self.image_root = image_root
        self.vocab = vocab
        self.train = train
        self.max_len = max_len
        # NOT gated on ``train``: the reference passes caption_drop /
        # random_erasing to the eval subset too (load_datasets.py:80-89).
        self.caption_drop_prob = caption_drop_prob
        self.random_erasing_prob = random_erasing_prob
        self.bert_tokenizer = bert_tokenizer
        self.bert_max_len = bert_max_len
        # Per-(index, epoch) rng: augmentation is deterministic under any
        # loader service order.
        self.rng = SampleRNG(seed)

        imgs, anns = _load_annotations(ann_path)
        if extra_ann_path:
            e_imgs, e_anns = _load_annotations(extra_ann_path)
            imgs.update(e_imgs)
            anns.update(e_anns)
        self._imgs = imgs
        self._anns = anns
        self._sizes = {}

        all_ids = list(ids) if ids is not None else list(anns.keys())
        if extra_ids is not None:
            all_ids += list(extra_ids)
        self.ids = [int(i) for i in all_ids]
        if ids is not None or extra_ids is not None:
            present = [i for i in self.ids if i in anns]
            if len(present) != len(self.ids) and not allow_missing_ids:
                # Dropping missing ids COMPACTS positions, so any frozen
                # position-indexed subset (coco_subset_idx) would silently
                # select different captions than the paper: a partial or
                # truncated annotation file must fail loudly (the
                # reference KeyErrors on the first missing id). Miniature
                # fixtures opt in via allow_missing_ids.
                raise ValueError(
                    f"{len(self.ids) - len(present)} of the "
                    f"{len(self.ids)} requested annotation ids are "
                    f"missing from {ann_path!r} (+extra); partial or "
                    "wrong annotation file?")
            if not present:
                raise ValueError(
                    f"none of the {len(self.ids)} requested annotation "
                    f"ids exist in {ann_path!r} (+extra); wrong "
                    "annotation file?")
            self.ids = present

        self.n_images = len({anns[i]["image_id"] for i in self.ids
                             if i in anns})
        self.iid_to_cls = None  # PMRP class mode unused by CreamFL
        self._native_vocab = None
        if native and vocab is not None:
            from creamfl_tpu_torch.data.native import NativeVocab

            self._native_vocab = NativeVocab(vocab)

    def __len__(self):
        return len(self.ids)

    def image_path(self, image_id: int) -> str:
        return os.path.join(self.image_root, self._imgs[int(image_id)])

    def image_size(self, image_id: int) -> Tuple[int, int]:
        """(w, h) from the image's JPEG header, read once."""
        size = self._sizes.get(image_id)
        if size is None:
            size = self._sizes[image_id] = read_size(
                self.image_path(image_id))
        return size

    def __getitem__(self, index: int):
        ann_id = self.ids[index]
        ann = self._anns[ann_id]
        image_id = ann["image_id"]
        caption = ann["caption"]
        rng = self.rng.for_index(index)
        w, h = self.image_size(image_id)
        params = imagenet_params(w, h, self.train, rng,
                                 random_erasing_prob=self.random_erasing_prob)
        if self._native_vocab is not None:
            toks, lens = self._native_vocab.tokenize_batch(
                [str(caption)], self.max_len, self.caption_drop_prob,
                seed=rng.getrandbits(63) if self.caption_drop_prob > 0
                else 0)
            tokens, n_ids = toks[0], int(lens[0])
        else:
            ids = caption_to_ids(caption, self.vocab,
                                 self.caption_drop_prob,
                                 rng)[: self.max_len]
            tokens = np.zeros((self.max_len,), np.int32)
            tokens[: len(ids)] = ids
            n_ids = len(ids)
        sample = {
            "image_src": np.int64(image_id),
            "image_params": params,
            "captions": tokens,
            "lengths": np.int32(n_ids),
            "ann_ids": np.int64(ann_id),
            "image_ids": np.int64(image_id),
            "index": np.int64(index),
        }
        if self.bert_tokenizer is not None:
            bids, bmask = self.bert_tokenizer.encode(str(caption),
                                                     self.bert_max_len)
            sample["bert_ids"] = np.asarray(bids, np.int32)
            sample["bert_mask"] = np.asarray(bmask, np.int32)
        return sample


class SubsetDataset:
    """torch.utils.data.Subset equivalent; re-indexes ``index`` so the
    distill bookkeeping sees subset-relative positions like the
    reference's Subset + enumerate pipeline."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)
        self.iid_to_cls = getattr(dataset, "iid_to_cls", None)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int):
        sample = dict(self.dataset[self.indices[i]])
        sample["index"] = np.int64(self.indices[i])
        return sample

    @property
    def n_images(self):
        return getattr(self.dataset, "n_images", None)


def load_or_create_subset_idx(path: str, total: int = 566435,
                              k: int = 50000,
                              seed: int = 2021) -> List[int]:
    """The frozen public-subset indices (reference
    load_datasets.py:148-162), through ``data.frozen``: a paper-scale
    ``k`` fails loudly when ``path`` is absent instead of resampling."""
    from creamfl_tpu_torch.data.frozen import load_subset_idx

    return load_subset_idx(path, pub_data_num=k, total=total, seed=seed)
