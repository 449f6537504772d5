"""Vocabulary: word<->id mapping, pickle-compatible with the reference.

The port's own copy of the JAX package's ``data/vocab.py`` (numpy-free,
unchanged). The reference ships ``coco_vocab.pkl`` as ``{'idx', 'word2idx', 'idx2word'}``
(`src/datasets/vocab.py:24-70`); this class loads/saves that exact format
so the committed vocab (load-bearing for token-id reproducibility) can be
reused, and can also be built from a caption corpus like
``make_vocab.py``.
"""

from __future__ import annotations

import pickle
from collections import Counter
from typing import Dict, Iterable, List

SPECIAL_TOKENS = ("<pad>", "<start>", "<end>", "<unk>")


class Vocabulary:
    def __init__(self):
        self.idx = 0
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx["<unk>"])

    def __len__(self) -> int:
        return len(self.word2idx)

    # -- reference pickle format --------------------------------------
    def load_from_pickle(self, path: str) -> "Vocabulary":
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.idx = data["idx"]
        self.word2idx = data["word2idx"]
        self.idx2word = data["idx2word"]
        return self

    def save_to_pickle(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"idx": self.idx, "word2idx": self.word2idx,
                         "idx2word": self.idx2word}, f)

    # -- constructors --------------------------------------------------
    @classmethod
    def build(cls, token_lists: Iterable[List[str]],
              threshold: int = 4) -> "Vocabulary":
        """Frequency-thresholded vocab (make_vocab.py semantics)."""
        counter = Counter()
        for tokens in token_lists:
            counter.update(tokens)
        vocab = cls()
        for tok in SPECIAL_TOKENS:
            vocab.add_word(tok)
        for word, count in counter.items():
            if count >= threshold:
                vocab.add_word(word)
        return vocab

    @classmethod
    def synthetic(cls, n_words: int = 100) -> "Vocabulary":
        """Deterministic small vocab for tests / synthetic data."""
        vocab = cls()
        for tok in SPECIAL_TOKENS:
            vocab.add_word(tok)
        for i in range(n_words):
            vocab.add_word(f"word{i}")
        return vocab
