"""Text-classification corpora (reference `src/datasets/dataset_L.py`).

Port of the JAX package's ``data/agnews.py``: ``Language`` reads the
torchtext-format CSVs (``train.csv``/``test.csv``: label,field,field,...)
under ``root/<name>``; labels are shifted to 0-base and sentences are
tokenized with the shared COCO vocabulary exactly like the reference
(dataset_L.py:167,189-195). Raises FileNotFoundError if the data is
absent.

``text_cls`` mirrors the reference's by-name corpus registry
(dataset_L.py:60-96): the 8 CSV corpora share the reader; ``IMDB`` is the
aclImdb folder-of-text-files layout. CreamFL itself only ever trains on
AG_NEWS (`MMFL.py:142`).
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from creamfl_tpu_torch.data.tokenize import caption_to_ids

#: name -> number of classes (reference dataset_L.py:60-96 comments).
CORPORA = {
    "AG_NEWS": 4,
    "SogouNews": 5,
    "DBpedia": 14,
    "YelpReviewPolarity": 2,
    "YelpReviewFull": 5,
    "YahooAnswers": 10,
    "AmazonReviewPolarity": 2,
    "AmazonReviewFull": 5,
    "IMDB": 2,
}


class Language:
    def __init__(self, root: str, name: str = "AG_NEWS", train: bool = True,
                 vocab=None, max_len: int = 64,
                 indices: Optional[list] = None):
        path = os.path.join(root, name, "train.csv" if train else "test.csv")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        labels, texts = [], []
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.reader(f):
                labels.append(int(row[0]))
                texts.append(" ".join(row[1:]))
        targets = np.asarray(labels, np.int64)
        targets -= targets.min()  # 0-base (reference dataset_L.py:167)
        self.targets = targets
        self.data = texts
        self.vocab = vocab
        self.max_len = max_len
        if indices is not None:
            idx = np.asarray(indices)
            self.targets = self.targets[idx]
            self.data = [self.data[i] for i in idx]

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, i: int):
        ids = caption_to_ids(self.data[i], self.vocab)[: self.max_len]
        tokens = np.zeros((self.max_len,), np.int32)
        tokens[: len(ids)] = ids
        return {"captions": tokens, "lengths": np.int32(len(ids)),
                "labels": np.int32(self.targets[i])}


class IMDB(Language):
    """aclImdb layout: root/IMDB/aclImdb/{train,test}/{neg,pos}/*.txt
    (torchtext.datasets.IMDB's extracted cache; dataset_L.py:94-95)."""

    def __init__(self, root: str, train: bool = True, vocab=None,
                 max_len: int = 64, indices: Optional[list] = None):
        base = os.path.join(root, "IMDB", "aclImdb",
                            "train" if train else "test")
        if not os.path.isdir(base):
            raise FileNotFoundError(base)
        labels, texts = [], []
        for label, sub in enumerate(("neg", "pos")):
            d = os.path.join(base, sub)
            for fname in sorted(os.listdir(d)):
                if not fname.endswith(".txt"):
                    continue
                with open(os.path.join(d, fname), encoding="utf-8") as f:
                    texts.append(f.read())
                labels.append(label)
        self.targets = np.asarray(labels, np.int64)
        self.data = texts
        self.vocab = vocab
        self.max_len = max_len
        if indices is not None:
            idx = np.asarray(indices)
            self.targets = self.targets[idx]
            self.data = [self.data[i] for i in idx]


def text_cls(name: str, root: str, train: bool = True, vocab=None,
             max_len: int = 64, indices: Optional[list] = None):
    """By-name corpus factory (reference ``text_cls``,
    dataset_L.py:60-96). Returns (dataset, n_classes)."""
    if name not in CORPORA:
        raise KeyError(f"unknown text corpus {name!r}; "
                       f"one of {sorted(CORPORA)}")
    if name == "IMDB":
        ds = IMDB(root, train=train, vocab=vocab, max_len=max_len,
                  indices=indices)
    else:
        ds = Language(root, name, train=train, vocab=vocab,
                      max_len=max_len, indices=indices)
    return ds, CORPORA[name]
