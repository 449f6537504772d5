"""Order-independent per-sample augmentation randomness.

The port's own copy of the JAX package's ``data/sample_rng.py``,
unchanged, so that both packages draw the same samples for one seed.

The reference draws augmentations from shared per-worker rng streams, so
sample randomness depends on which worker served which index —
irreproducible across loader backends/worker counts. Here each
``__getitem__`` derives its rng from ``(dataset_seed, index, epoch)``:
deterministic for any service order (grain's reader pool completes
indices slightly out of order even at worker_count=0), identical across
the array and grain backends — including grain multi-worker runs, where
the dataset is re-pickled into fresh worker processes each epoch, and
pad-slot refetches, which must reproduce the row they duplicate — and
still varying across epochs.

The epoch is EXPLICIT state set by the loaders (``set_epoch`` below,
the torch ``DistributedSampler.set_epoch`` pattern) rather than a
mutable per-index visit counter: counters live in whichever process
ran ``__getitem__`` and die with grain workers at the end of every
epoch, which would silently freeze augmentations across epochs on the
multi-worker path.
"""

from __future__ import annotations

import random


class SampleRNG:
    def __init__(self, seed: int = 2021):
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def for_index(self, index: int) -> random.Random:
        # int() coercion matters: grain hands datasets np.int64 record
        # keys, and the multiplicative mix below would silently wrap in
        # fixed-width numpy arithmetic — a different seed than the
        # arbitrary-precision python-int mix the array backend computes.
        index = int(index)
        # Knuth-multiplicative mix into one stable 64-bit seed
        # (random.Random rejects tuples; hash() would work for ints but
        # explicit mixing documents the stability requirement).
        mixed = (((self.seed * 2654435761 + index) * 2654435761
                  + self.epoch) & 0xFFFFFFFFFFFFFFFF)
        return random.Random(mixed)


def set_epoch(dataset, epoch: int) -> None:
    """Advance the SampleRNG epoch of ``dataset`` and every dataset it
    wraps (Subset/CachedDataset chains expose the inner one as
    ``.dataset``). Loaders call this once per epoch before iterating;
    datasets without a SampleRNG are untouched."""
    seen = set()
    while dataset is not None and id(dataset) not in seen:
        seen.add(id(dataset))
        rng = getattr(dataset, "rng", None)
        if isinstance(rng, SampleRNG):
            rng.set_epoch(epoch)
        dataset = getattr(dataset, "dataset", None)
