"""The native caption tokenizer (``csrc/native.cpp``), bound with ctypes.

The same library holds the PNG and GIF pixel work of ``data/png_gif.py``
(``png_decode``, ``gif_decode``), bound here too.

Port of the JAX package's ``data/native.py``, its tokenizer part. The JAX
package's COCO reader tokenizes through its native library whenever that
library is built, and the library draws caption drops from a
``std::mt19937_64`` seeded by the reader: another stream than the Python
``caption_to_ids``. The port's COCO reader takes this tokenizer by default,
so that its ids equal the JAX package's bit for bit.

The library is built with g++ (``ops/build.py`` ``GXX_FLAGS``) at first
use, into the git-ignored ``_build/``; a failed build raises with the
compiler's output. No Python fallback: a reader that asks for the Python
tokenizer says so (``CocoCaptionsCap(native=False)``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np

from creamfl_tpu_torch.ops import build as builder

SOURCE = builder.CSRC / "native.cpp"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _, _ = builder.build(SOURCE, compiler="g++",
                               flags=builder.GXX_FLAGS)
    lib = ctypes.CDLL(str(path))
    lib.vocab_create.restype = ctypes.c_void_p
    lib.vocab_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.vocab_free.argtypes = [ctypes.c_void_p]
    lib.vocab_lookup.restype = ctypes.c_int32
    lib.vocab_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tokenize_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int32, ctypes.c_float, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.png_decode.restype = i
    lib.png_decode.argtypes = [p, i64, i64, i64, i, i, i, p, i, p]
    lib.gif_decode.restype = i
    lib.gif_decode.argtypes = [p, i64, i, i64, i64, i64, i64, i64, i64, i,
                               p, i, i, p]
    return lib


class NativeVocab:
    """The native hash-map vocab bound to a Python ``Vocabulary``.

    Picklable: the library handle and the C vocab pointer belong to the
    process, so pickling ships only the Python vocabulary and the handle
    is rebuilt where it is unpickled."""

    def __init__(self, vocab):
        self._vocab = vocab
        self._bind(vocab)

    def _bind(self, vocab):
        lib = _lib()
        self._lib = lib
        words = list(vocab.word2idx.keys())
        ids = np.asarray([vocab.word2idx[w] for w in words], np.int32)
        arr = (ctypes.c_char_p * len(words))(
            *[w.encode("utf-8") for w in words])
        self._handle = lib.vocab_create(
            arr, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(words), vocab("<start>"), vocab("<end>"), vocab("<unk>"))

    def __getstate__(self):
        return {"_vocab": self._vocab}

    def __setstate__(self, state):
        self._vocab = state["_vocab"]
        self._bind(self._vocab)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.vocab_free(handle)

    def lookup(self, word: str) -> int:
        return int(self._lib.vocab_lookup(self._handle,
                                          word.encode("utf-8")))

    def tokenize_batch(self, texts: Sequence[str], max_len: int,
                       caption_drop_prob: float = 0.0,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """([n, max_len] int32 ids, [n] int32 lengths): ``<start>``, the
        tokens, ``<end>``, cut at ``max_len``; with ``caption_drop_prob``
        > 0 the drops are drawn from an mt19937_64 seeded with ``seed``."""
        n = len(texts)
        out_ids = np.zeros((n, max_len), np.int32)
        out_lens = np.zeros((n,), np.int32)
        arr = (ctypes.c_char_p * n)(*[t.encode("utf-8") for t in texts])
        self._lib.tokenize_batch(
            self._handle, arr, n, max_len,
            ctypes.c_float(caption_drop_prob), ctypes.c_uint64(seed),
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out_ids, out_lens
