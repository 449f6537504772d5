"""The inputs of a run, worked out from its seed as the port's synthetic
paper-scale bundle makes them (frozen copies of the port's
``data/synthetic.py``, ``data/device_synth.py``, ``data/tokenize.py``'s
synthetic WordPiece and ``data/loaders.py``'s row order).

A caption set is ``SyntheticCaptionDataset(seed=...)``: caption ``i``
shows image ``i // 5``, whose concept is a hash of its id; its image is
noise keyed by ``(set seed, image id)`` plus the concept's pattern. The
set's seed is fixed by the bundle (1 for the public set, 100 + k for mm
client k); a run's ``--seed`` orders the loaders and draws the weights.
The synthetic BERT ids hash each word with ``hash()``: a run and its
reference share ``PYTHONHASHSEED`` (the harness fixes it).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence

import numpy as np
import torch

ROUND_EPOCH_STRIDE = 1 << 20
N_CONCEPTS, SIGNAL, CAPTIONS_PER_IMAGE = 10, 0.8, 5
# Vocabulary.synthetic(100): <pad>, <start>, <end>, <unk>, then 100 words.
VOCAB_LEN, START, END = 104, 1, 2
# BertWordPieceTokenizer.synthetic(500): [PAD] [UNK] [CLS] [SEP], then 500.
BERT_PAD, BERT_CLS, BERT_SEP, BERT_WORDS = 0, 2, 3, 500
BERT_MAX_LEN = 32

_MASK = 0xFFFFFFFF
_MUL = 0x45D9F3B
_GOLDEN = 0x9E3779B1


def concept(set_seed: int, image_id: int) -> int:
    return (image_id * 2654435761 + set_seed) % N_CONCEPTS


def concept_pattern(size: int, c: int, signal: float = SIGNAL) -> np.ndarray:
    lin = np.linspace(0, 2 * np.pi, size)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([signal * np.sin((c + 1) * xx),
                     signal * np.cos((c + 1) * yy),
                     np.zeros_like(xx)], axis=-1).astype(np.float32)


def _mix32(x):
    x = ((x >> 16) ^ x) * _MUL & _MASK
    x = ((x >> 16) ^ x) * _MUL & _MASK
    return (x >> 16) ^ x


def images(set_seed: int, image_ids: Sequence[int], size: int,
           device) -> torch.Tensor:
    """[B, size, size, 3] float32 NHWC: Box-Muller normals from a counter
    hash of (set seed, image id, element), in float64, plus the concept
    pattern."""
    ids = torch.as_tensor(np.asarray(image_ids, np.int64), device=device)
    n = size * size * 3
    counter = (torch.arange(2 * (-(-n // 2)), dtype=torch.int64,
                            device=device) * _GOLDEN)[None, :]
    keys = (_mix32((set_seed & _MASK) ^ 0x243F6A88),
            _mix32((set_seed & _MASK) ^ 0x85A308D3))
    lo, hi = ids & _MASK, (ids >> 32) & _MASK
    ka, kb = (_mix32(_mix32(lo ^ k) ^ hi)[:, None] for k in keys)
    bits = _mix32(_mix32((counter + ka) & _MASK) ^ kb)
    scale = 2.0 ** -32
    u1 = (bits[:, 0::2] + 1).double() * scale
    theta = bits[:, 1::2].double() * (2 * math.pi * scale)
    r = torch.sqrt(-2.0 * torch.log(u1))
    z = torch.stack((r * torch.cos(theta), r * torch.sin(theta)), -1)
    noise = z.reshape(len(ids), -1)[:, :n].float().view(-1, size, size, 3)
    pats = torch.from_numpy(np.stack([
        concept_pattern(size, concept(set_seed, int(i)))
        for i in image_ids])).to(device)
    return noise + pats


def host_images(set_seed: int, image_ids: Sequence[int],
                size: int) -> torch.Tensor:
    """The host-rendered images of the small (``--smoke``) bundle:
    float32 normals from a PCG64 stream of (set seed, image id), plus the
    concept pattern on the first two channels."""
    out = np.empty((len(image_ids), size, size, 3), np.float32)
    for i, iid in enumerate(image_ids):
        rng = np.random.default_rng(np.random.PCG64(
            set_seed * 1_000_003 + int(iid)))
        img = rng.standard_normal((size, size, 3), dtype=np.float32)
        pat = concept_pattern(size, concept(set_seed, int(iid)))
        img[..., 0] += pat[..., 0]
        img[..., 1] += pat[..., 1]
        out[i] = img
    return torch.from_numpy(out)


def _caption_body(set_seed: int, index: int, max_len: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.PCG64((set_seed + 1) * 1_000_003
                                                + index))
    length = int(rng.integers(6, max_len))
    body = rng.integers(4, VOCAB_LEN, size=(length - 2,)).astype(np.int32)
    c = concept(set_seed, index // CAPTIONS_PER_IMAGE)
    vsize = VOCAB_LEN - 4
    body[0] = 4 + (c * 7) % vsize
    if length > 4:
        body[1] = 4 + (c * 13 + 3) % vsize
    return body


def captions(set_seed: int, rows: Sequence[int], max_len: int
             ) -> Dict[str, np.ndarray]:
    """The caption fields of ``rows``: ``captions`` [B, max_len] and
    ``lengths`` (the GRU branch), ``bert_ids`` and ``bert_mask`` [B, 32]
    (the BERT branch), ``image_ids``."""
    b = len(rows)
    caps = np.zeros((b, max_len), np.int64)
    lengths = np.zeros((b,), np.int64)
    bert = np.full((b, BERT_MAX_LEN), BERT_PAD, np.int64)
    mask = np.zeros((b, BERT_MAX_LEN), np.int64)
    for i, row in enumerate(rows):
        body = _caption_body(set_seed, int(row), max_len)
        n = len(body) + 2
        caps[i, 0], caps[i, 1:n - 1], caps[i, n - 1] = START, body, END
        lengths[i] = n
        words = [str(int(t)) for t in body[:8]]
        ids = [BERT_CLS] + [4 + hash(w) % BERT_WORDS for w in words]
        ids = ids[:BERT_MAX_LEN - 1] + [BERT_SEP]
        bert[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1
    return {"captions": caps, "lengths": lengths, "bert_ids": bert,
            "bert_mask": mask,
            "image_ids": np.asarray(rows, np.int64) // CAPTIONS_PER_IMAGE}


def epoch_order(n_rows: int, loader_seed: int, round_n: int,
                k: int = 0, shuffle: bool = True) -> List[int]:
    """Row order of the ``k``-th epoch a loader starts in round
    ``round_n`` (the round addressing every loader takes at round entry)."""
    order = list(range(n_rows))
    if shuffle:
        random.Random(loader_seed * 2_147_483_659
                      + round_n * ROUND_EPOCH_STRIDE + k).shuffle(order)
    return order


def batches(order: Sequence[int], batch_size: int) -> List[List[int]]:
    """Consecutive batches of ``order``, the last one ragged."""
    return [list(order[i:i + batch_size])
            for i in range(0, len(order), batch_size)]
