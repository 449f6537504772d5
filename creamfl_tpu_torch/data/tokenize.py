"""Caption tokenization (reference `src/utils/load_datasets.py:277-315`).

The port's own copy of the JAX package's ``data/tokenize.py``: the same
functions and ids; the module imports only ``re``, ``unicodedata`` and
``zlib`` (nltk at the first Treebank call). The server's BERT branch reads
``BertWordPieceTokenizer`` ids (``.synthetic`` on the synthetic path), its
decoder towers' ``SyntheticLMTokenizer`` ids (the port's own).

The reference runs ``nltk.word_tokenize`` (punkt sentence split + Treebank
word tokenizer). ``TreebankWordTokenizer`` alone gives the same output for
single-sentence captions (COCO/F30k captions are single sentences); a
pure-regex fallback covers nltk-free installs.

Caption-drop augmentation reproduces the reference's *double* application
quirk exactly: with prob p each token is replaced by ``<unk>``, and then
``int(len * p)`` random tokens are deleted outright
(load_datasets.py:286-293 applies both).
"""

from __future__ import annotations

import random
import re
import unicodedata
import zlib
from typing import List, Optional, Sequence

import numpy as np

_FALLBACK_RE = re.compile(r"[a-zA-Z0-9]+|[^\sa-zA-Z0-9]")
_TREEBANK = []  # the nltk tokenizer, or None without nltk; made at first use


def treebank_tokenize(sentence: str) -> List[str]:
    """nltk's Treebank tokenizer where nltk is installed (imported at the
    first call, not with the module: the synthetic path never needs it),
    else the regex fallback, as the JAX package's module does."""
    if not _TREEBANK:
        try:
            from nltk.tokenize.treebank import TreebankWordTokenizer

            _TREEBANK.append(TreebankWordTokenizer())
        except Exception:
            _TREEBANK.append(None)
    text = str(sentence).lower()
    if _TREEBANK[0] is not None:
        return _TREEBANK[0].tokenize(text)
    return _FALLBACK_RE.findall(text)


def caption_to_ids(sentence, vocab, caption_drop_prob: float = 0.0,
                   rng: Optional[random.Random] = None) -> List[int]:
    """Tokenize + <start>/<end> wrap + drop augmentation -> id list."""
    rng = rng or random
    tokens = treebank_tokenize(sentence)
    ids = []
    unk = vocab("<unk>")
    if caption_drop_prob > 0:
        body = [vocab(t) if rng.random() > caption_drop_prob else unk
                for t in tokens]
        n_del = int(len(body) * caption_drop_prob)
        for _ in range(n_del):
            body.pop(rng.randrange(len(body)))
    else:
        body = [vocab(t) for t in tokens]
    ids.append(vocab("<start>"))
    ids.extend(body)
    ids.append(vocab("<end>"))
    return ids


# ---------------------------------------------------------------------------
# BERT WordPiece (server text branch; precomputed in the pipeline, see
# the JAX package's models/bert.py docstring)
# ---------------------------------------------------------------------------


def _is_bert_whitespace(ch: str) -> bool:
    # " \t\n\r" plus any unicode space separator (Zs).
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_bert_control(ch: str) -> bool:
    # \t\n\r count as whitespace, everything else in category C* is
    # stripped by the cleaner.
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_bert_punctuation(ch: str) -> bool:
    # The original BERT treats all non-letter/number ASCII as
    # punctuation ("^" or "$" included) plus every unicode P* char.
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk_codepoint(cp: int) -> bool:
    # CJK Unified Ideographs blocks (spaced out so each ideograph
    # becomes its own word, per the original BERT basic tokenizer).
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BertWordPieceTokenizer:
    """Greedy longest-match WordPiece over a BERT vocab.

    Reproduces ``transformers.BertTokenizer`` (the slow python one the
    reference instantiates at `src/networks/models/pcme.py:32` and runs
    in-forward at `pcme.py:40-44`) for ``do_lower_case=True`` defaults:
    control-char cleanup, CJK spacing, NFC normalization, lowercasing,
    accent stripping (NFD, drop Mn), unicode punctuation splitting, then
    greedy ``##`` WordPiece with the 100-char [UNK] bail. Fuzz-verified
    against the HF implementation in tests/test_wordpiece_fuzz.py.

    ``vocab`` maps token -> id and must contain [CLS]/[SEP]/[UNK]/[PAD].
    Load from an HF ``vocab.txt`` when available (``from_vocab_file``);
    ``synthetic`` provides a deterministic small vocab for tests.
    """

    def __init__(self, vocab: dict, max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk = vocab["[UNK]"]
        self.cls = vocab["[CLS]"]
        self.sep = vocab["[SEP]"]
        self.pad = vocab["[PAD]"]
        self.max_chars = max_input_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str) -> "BertWordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    @classmethod
    def synthetic(cls, n_words: int = 500) -> "BertWordPieceTokenizer":
        vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
        for i in range(n_words):
            vocab[f"tok{i}"] = len(vocab)
        # Hash any word onto the synthetic token space so synthetic runs
        # still exercise the full BERT path deterministically.
        tok = cls(vocab)
        tok._synthetic_n = n_words
        return tok

    def _basic_tokens(self, text: str) -> List[str]:
        # Clean (drop NUL/U+FFFD/control, normalize whitespace) and
        # space out CJK ideographs in one pass, then NFC-normalize —
        # the same order the HF BasicTokenizer applies.
        buf = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_bert_control(ch):
                continue
            if _is_bert_whitespace(ch):
                buf.append(" ")
            elif _is_cjk_codepoint(cp):
                buf.append(f" {ch} ")
            else:
                buf.append(ch)
        text = unicodedata.normalize("NFC", "".join(buf))
        out: List[str] = []
        for token in text.split():
            # do_lower_case=True implies accent stripping (NFD, drop
            # combining marks) in the original BERT.
            token = unicodedata.normalize("NFD", token.lower())
            word = []
            for ch in token:
                if unicodedata.category(ch) == "Mn":
                    continue
                if _is_bert_punctuation(ch):
                    if word:
                        out.append("".join(word))
                        word = []
                    out.append(ch)
                else:
                    word.append(ch)
            if word:
                out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if getattr(self, "_synthetic_n", None):
            return [self.vocab[f"tok{hash(word) % self._synthetic_n}"]]
        if len(word) > self.max_chars:
            return [self.unk]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            out.append(cur)
            start = end
        return out

    def encode(self, text: str, max_length: int = 64):
        """-> (ids, attention_mask) padded/truncated to max_length."""
        ids = [self.cls]
        for word in self._basic_tokens(text):
            ids.extend(self._wordpiece(word))
            if len(ids) >= max_length - 1:
                break
        ids = ids[: max_length - 1] + [self.sep]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return ids + [self.pad] * pad, mask + [0] * pad

    def encode_batch(self, texts: Sequence[str], max_length: int = 64):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, max_length)
        return ids, mask


class SyntheticLMTokenizer:
    """The synthetic captions as a decoder LM's ids (a decoder tower
    on ``--synthetic``; its own BPE needs the model's ``tokenizer.json``):
    ``bos``, each word's id under a seeded map into ``[0, bos)``, ``eos``,
    right-padded with ``eos`` under a zero mask. A word's id is
    ``table[crc32(word) % N_WORDS]``, ``table`` ``N_WORDS`` distinct ids
    drawn from numpy's PCG64 at ``SEED``: the same in every process."""

    N_WORDS, SEED = 1024, 19

    def __init__(self, bos: int, eos: int):
        self.bos, self.eos = bos, eos
        self.table = np.random.default_rng(self.SEED).choice(
            bos, size=min(self.N_WORDS, bos), replace=False)

    def word_id(self, word: str) -> int:
        return int(self.table[zlib.crc32(word.encode()) % len(self.table)])

    def encode(self, text: str, max_length: int = 64):
        """-> (ids, attention_mask) padded/truncated to max_length."""
        words = text.split()[:max_length - 2]
        ids = [self.bos] + [self.word_id(w) for w in words] + [self.eos]
        pad = max_length - len(ids)
        return ids + [self.eos] * pad, [1] * len(ids) + [0] * pad
