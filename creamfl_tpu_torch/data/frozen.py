"""Packaged frozen reproducibility artifacts.

The port's own copy of the JAX package's ``data/frozen.py`` and of its
artifacts, byte for byte, in the same subdirectories of this package:

  * ``artifacts/coco_subset_idx_file``: the 50 000 public-set caption
    indices (reference ``coco_subset_idx_file``, consumed at
    ``src/utils/load_datasets.py:148-162``);
  * ``annotations/coco_{train,restval,dev,test}_ids.npy``: the Karpathy
    COCO split annotation ids (``src/utils/load_datasets.py:109-112``);
  * ``vocabs/coco_vocab.pkl``: the COCO vocabulary
    (``src/datasets/vocabs/coco_vocab.pkl``);
  * ``partitions/client_{cifar100,AG_NEWS}_noniid.pkl``,
    ``partitions/client_noniid_flicker30k.pkl``: the non-IID client
    index splits (``data_partition/``,
    ``src/datasets/load_FL_datasets.py:79-120``).

Paper-scale runs must not silently regenerate any of these (a fresh
sample trains on a *different* 50k subset or client split than the
paper), so the loaders here fail loudly when an explicitly requested
artifact is absent at paper scale and only fall back to deterministic
regeneration for scaled-down smoke configs.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import List, Optional

_DATA_DIR = os.path.dirname(__file__)

#: Caption count of the merged train2014+restval COCO caption set the
#: public subset indexes into (reference load_datasets.py:150).
COCO_MERGED_CAPTIONS = 566435

#: The paper's public-set size (``--pub_data_num`` default).
PAPER_PUB_DATA_NUM = 50000


def annotations_dir() -> str:
    return os.path.join(_DATA_DIR, "annotations")


def coco_ids_path(split: str) -> str:
    """``split`` in {train, restval, dev, test}."""
    return os.path.join(annotations_dir(), f"coco_{split}_ids.npy")


def coco_vocab_path() -> str:
    return os.path.join(_DATA_DIR, "vocabs", "coco_vocab.pkl")


def partitions_dir() -> str:
    return os.path.join(_DATA_DIR, "partitions")


def subset_idx_path() -> str:
    return os.path.join(_DATA_DIR, "artifacts", "coco_subset_idx_file")


def load_subset_idx(path: Optional[str] = None,
                    pub_data_num: int = PAPER_PUB_DATA_NUM,
                    total: int = COCO_MERGED_CAPTIONS,
                    seed: int = 2021) -> List[int]:
    """The frozen public-subset indices.

    ``path=None`` loads the packaged copy (always present). An explicit
    ``path`` that does not exist fails loudly at paper scale
    (``pub_data_num >= 50000``): silently resampling there would train on
    a different public set than the paper. It regenerates
    deterministically only for scaled-down smoke configs (reference
    fallback, ``load_datasets.py:148-156``).
    """
    if path is None:
        path = subset_idx_path()
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    if pub_data_num >= PAPER_PUB_DATA_NUM:
        raise FileNotFoundError(
            f"frozen public-subset index file {path!r} is missing; a "
            f"paper-scale run (pub_data_num={pub_data_num}) must use the "
            "frozen 50k subset for reproducibility. Use the packaged "
            f"copy ({subset_idx_path()!r}) or restore the file.")
    rng = random.Random(seed)
    idx = sorted(rng.sample(range(total), pub_data_num))
    with open(path, "wb") as f:
        pickle.dump(idx, f)
    return idx


def load_coco_ids(split: str, required: bool = True):
    """Karpathy split annotation ids; loud failure when required."""
    import numpy as np

    path = coco_ids_path(split)
    if not os.path.exists(path):
        if required:
            raise FileNotFoundError(
                f"frozen COCO split id file {path!r} is missing: the "
                "Karpathy train/restval/dev/test splits are packaged "
                "artifacts; without them the dataset would silently "
                "fall back to ALL annotations.")
        return None
    return np.load(path)
