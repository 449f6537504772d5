"""Text-classification corpora (reference `src/datasets/dataset_L.py`).

Port of ``Language`` and ``CORPORA`` of the JAX package's
``data/agnews.py``: ``Language`` reads the torchtext-format CSVs
(``train.csv``/``test.csv``: label,field,field,...) under ``root/<name>``;
labels are shifted to 0-base and sentences are tokenized with the shared
COCO vocabulary exactly like the reference (dataset_L.py:167,189-195).
Raises FileNotFoundError if the data is absent. CreamFL itself only ever
trains on AG_NEWS (`MMFL.py:142`).
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
