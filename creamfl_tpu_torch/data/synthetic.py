"""Synthetic datasets for every modality.

The port's own copy of the JAX package's ``data/synthetic.py``, unchanged:
for one seed both packages render bit-equal samples.

This build environment has zero egress: MS-COCO images, CIFAR-100,
AG_NEWS, Flickr30k and GloVe cannot be downloaded. Each real dataset
reader (coco.py, cifar.py, agnews.py, flickr30k.py) therefore has a
shape-identical synthetic twin here, used by tests, smoke configs and the
benchmark harness. Samples are generated deterministically from
(seed, index) so loaders stay O(1) in memory.

Sample dict schema (matches the reference's 7-tuple collate,
`_dataloader.py:35-64`):
  images [H,W,3] float32 normalized / captions [L] int32 / lengths scalar
  / ann_id / image_id / index (+ labels for classification sets).
"""

from __future__ import annotations

import numpy as np

from creamfl_tpu_torch.data.vocab import Vocabulary


def concept_pattern(image_size: int, concept: int,
                    signal: float) -> np.ndarray:
    """[s, s, 3] class-dependent low-frequency pattern (sin on R, cos on
    G, zero B) — THE definition of the synthetic concept signal, shared
    by the host path (``SyntheticCaptionDataset._image``) and the
    on-accelerator path (``device_synth.DeviceImageSynth``) so the two
    render the same distribution."""
    lin = np.linspace(0, 2 * np.pi, image_size)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([signal * np.sin((concept + 1) * xx),
                     signal * np.cos((concept + 1) * yy),
                     np.zeros_like(xx)], axis=-1).astype(np.float32)


def _img_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.PCG64(seed * 1_000_003 + index))


class SyntheticCaptionDataset:
    """COCO/F30k-style paired image-caption set. ``captions_per_image``
    controls the image-id grouping used by retrieval eval (COCO ~5).

    Each image carries a latent concept class; the image gets a
    class-dependent spatial pattern and its captions get
    class-correlated tokens, so cross-modal *learning* is measurable on
    synthetic data (retrieval above chance), not just shapes.
    """

    def __init__(self, n_captions: int = 256, image_size: int = 224,
                 max_len: int = 16, vocab: Vocabulary | None = None,
                 captions_per_image: int = 5, seed: int = 0,
                 n_concepts: int = 10, signal: float = 0.8,
                 bert_tokenizer=None, bert_max_len: int = 32,
                 with_images: bool = True):
        self.n = n_captions
        self.image_size = image_size
        self.max_len = max_len
        self.vocab = vocab or Vocabulary.synthetic(100)
        self.cpi = captions_per_image
        self.seed = seed
        self.n_concepts = n_concepts
        self.signal = signal
        self.n_images = -(-n_captions // captions_per_image)
        self.iid_to_cls = None
        self.bert_tokenizer = bert_tokenizer
        self.with_images = with_images
        self.bert_max_len = bert_max_len

    def _concept(self, image_id: int) -> int:
        return (image_id * 2654435761 + self.seed) % self.n_concepts

    def _image(self, image_id: int, concept: int) -> np.ndarray:
        rng = _img_rng(self.seed, image_id)
        # float32 sampling: half the bits + no astype pass vs
        # normal().astype (2x faster at paper scale).
        img = rng.standard_normal(
            (self.image_size, self.image_size, 3), dtype=np.float32)
        # Class-dependent low-frequency pattern (visible through convs).
        pat0, pat1 = self._pattern(concept)
        img[..., 0] += pat0
        img[..., 1] += pat1
        return img

    def _pattern(self, concept: int):
        """Per-concept class pattern, cached (n_concepts small; computing
        sin/cos per sample dominated paper-scale pre-rendering)."""
        if not hasattr(self, "_pattern_cache"):
            self._pattern_cache = {}
        if concept not in self._pattern_cache:
            pat = concept_pattern(self.image_size, concept, self.signal)
            self._pattern_cache[concept] = (pat[..., 0], pat[..., 1])
        return self._pattern_cache[concept]

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        image_id = index // self.cpi
        concept = self._concept(image_id)
        img = (self._image(image_id, concept)
               if self.with_images else None)

        crng = _img_rng(self.seed + 1, index)
        length = int(crng.integers(6, self.max_len))
        body = crng.integers(4, len(self.vocab),
                             size=(length - 2,)).astype(np.int32)
        # Concept-correlated tokens: a deterministic concept bigram
        # occupies the first two body slots.
        vsize = len(self.vocab) - 4
        body[0] = 4 + (concept * 7) % vsize
        if length > 4:
            body[1] = 4 + (concept * 13 + 3) % vsize
        ids = np.zeros((self.max_len,), np.int32)
        ids[0] = self.vocab("<start>")
        ids[1:length - 1] = body
        ids[length - 1] = self.vocab("<end>")
        sample = {
            "captions": ids,
            "lengths": np.int32(length),
            "ann_ids": np.int64(index),
            "image_ids": np.int64(image_id),
            "index": np.int64(index),
        }
        if img is not None:
            sample["images"] = img
        if self.bert_tokenizer is not None:
            words = " ".join(str(i) for i in body[:8])
            bids, bmask = self.bert_tokenizer.encode(words,
                                                     self.bert_max_len)
            sample["bert_ids"] = np.asarray(bids, np.int32)
            sample["bert_mask"] = np.asarray(bmask, np.int32)
        return sample


class SyntheticImageClassification:
    """CIFAR-style labelled images."""

    def __init__(self, n: int = 512, image_size: int = 64,
                 num_classes: int = 100, seed: int = 0):
        self.n = n
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.targets = (np.arange(n) * 31 + seed) % num_classes

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        rng = _img_rng(self.seed + 7, index)
        label = self.targets[index]
        # Weak class-correlated signal so training can actually learn.
        img = rng.normal(0.0, 1.0,
                         (self.image_size, self.image_size, 3))
        img[..., 0] += 0.1 * (label % 10)
        return {"images": img.astype(np.float32),
                "labels": np.int32(label)}


class SyntheticTextClassification:
    """AG_NEWS-style labelled token sequences."""

    def __init__(self, n: int = 512, num_classes: int = 4,
                 max_len: int = 16, vocab: Vocabulary | None = None,
                 seed: int = 0):
        self.n = n
        self.num_classes = num_classes
        self.max_len = max_len
        self.vocab = vocab or Vocabulary.synthetic(100)
        self.seed = seed
        self.targets = (np.arange(n) * 17 + seed) % num_classes

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        rng = _img_rng(self.seed + 13, index)
        label = self.targets[index]
        length = int(rng.integers(3, self.max_len))
        ids = np.zeros((self.max_len,), np.int32)
        # Class-correlated token prefix.
        ids[:length] = (rng.integers(4, len(self.vocab), size=(length,))
                        + label) % len(self.vocab)
        ids[:length] = np.maximum(ids[:length], 4)
        return {"captions": ids, "lengths": np.int32(length),
                "labels": np.int32(label)}
