"""Batching and collation for static shapes.

The port's own copy of the JAX package's ``data/loaders.py``: the same
batches, pads and epoch order for one seed.

The reference's DataLoaders sort each batch by caption length and pad to
the batch max (`src/datasets/_dataloader.py:35-64`). Here, as in the JAX
package, captions pad to a fixed ``max_len`` per dataset and lengths ride
along as an int32 array; sorting is dropped (the GRU packs per batch
itself; order only affected batch statistics).

``ArrayLoader`` is a minimal epoch iterator over an indexable dataset
producing dict-of-ndarray batches; it covers the reference's shuffle /
drop_last surface and optionally pads the final partial batch (with a
``valid`` mask) so eval loops also see one static shape.

Tracing (``utils/profiling.py``): each ``next()`` of the outermost loader a
thread iterates (``ArrayLoader``, ``PrefetchLoader``, the worker loader,
``DeviceImageBatches``, ``DeviceImages``) is a ``creamfl.data.next`` span
and counts in ``data.batches``; a prefetch thread's work a batch is a
``creamfl.data.produce`` span, and a consumer that finds the prefetch
queue empty counts in ``data.queue_empty``.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from creamfl_tpu_torch.utils import profiling

# Round-mode epoch ids are round * STRIDE + k (k-th iteration within the
# round); large enough that successive rounds never collide for any
# realistic per-round epoch count.
ROUND_EPOCH_STRIDE = 1 << 20


def collate_captions(token_lists: Sequence[Sequence[int]],
                     max_len: int) -> Dict[str, np.ndarray]:
    """Pad id lists to [B, max_len] + lengths (clipped to max_len)."""
    b = len(token_lists)
    out = np.zeros((b, max_len), np.int32)
    lengths = np.zeros((b,), np.int32)
    for i, ids in enumerate(token_lists):
        ids = list(ids)[:max_len]
        out[i, :len(ids)] = ids
        lengths[i] = len(ids)
    return {"captions": out, "lengths": lengths}


def stack_samples(samples: Sequence[dict], n_valid: int) -> Dict[str, Any]:
    """Stack sample dicts into one dict-of-ndarray batch + ``valid``
    mask (string fields collect into lists). Shared by ArrayLoader and
    the grain batch view so both backends emit identical batches."""
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            batch[key] = vals
        else:
            batch[key] = np.stack([np.asarray(v) for v in vals])
    batch["valid"] = (np.arange(len(samples)) < n_valid)
    return batch


def batch_indices(order: Sequence[int], b: int, batch_size: int,
                  pad_last: bool):
    """Row indices of batch ``b`` of an epoch's ``order`` and its count of
    valid rows: a short final batch is repeat-padded (``idxs[i % n_valid]``)
    when ``pad_last``, else left ragged. Shared by ArrayLoader and the
    worker loader's batch view, so both backends make the same batches."""
    idxs = list(order[b * batch_size:(b + 1) * batch_size])
    n_valid = len(idxs)
    if n_valid < batch_size and pad_last:
        idxs += [idxs[i % n_valid] for i in range(batch_size - n_valid)]
    return idxs, n_valid


def outermost(batches) -> Iterator:
    """``batches`` as a loader hands them over: each ``next()`` a
    ``creamfl.data.next`` span counted in ``data.batches``, unless the
    thread is inside another loader's ``next()`` or producing for a
    prefetch queue already (a ``creamfl.data.*`` span is open)."""
    return profiling.spanned(batches, "creamfl.data.next",
                             unless="creamfl.data.", counter="data.batches")


def suffix_valid(valid: np.ndarray) -> int:
    """Count valid rows in a batch's ``valid`` mask, asserting the
    ArrayLoader pad contract: pads (``pad_last``) are always a suffix,
    so consumers may slice ``[:n_valid]`` after concatenation."""
    assert valid.all() or not valid[valid.argmin():].any(), \
        "pad must be a suffix"
    return int(valid.sum())


class ArrayLoader:
    """Epoch iterator: dataset[index] -> sample dict; batches stacked.

    Args:
      dataset: indexable with __len__ returning sample dicts of ndarrays
        / scalars (string fields are collected into lists).
      batch_size: fixed batch size.
      shuffle: reshuffle each epoch (seeded).
      drop_last: drop the trailing partial batch (training).
      pad_last: if not dropping, repeat-pad the final batch to full size
        and emit a boolean ``valid`` mask (evaluation under jit).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, pad_last: bool = True,
                 seed: int = 2021,
                 collate_fn: Optional[Callable[[List[dict]], dict]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.seed = seed
        self.rng = random.Random(seed)
        self.collate_fn = collate_fn
        self._epoch = 0
        self._round = None
        self._round_k = 0

    def set_round(self, round_n: int) -> None:
        """Switch epoch addressing to ``(seed, round, k-th iteration)``
        so batch order and per-sample augmentation draws become a pure
        function of the round index: a fresh process that ``--resume``s
        at round R replays exactly the epochs a straight run would see
        (the default stateful stream depends on how many epochs ran
        before — unreplayable after a restart). MMFL.train calls this
        on every loader at round entry (federation/rounds.py)."""
        self._round = int(round_n)
        self._round_k = 0

    def _next_epoch_id(self) -> int:
        if self._round is None:
            epoch = self._epoch
            self._epoch += 1
            return epoch
        epoch = self._round * ROUND_EPOCH_STRIDE + self._round_k
        self._round_k += 1
        return epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def skip_epoch(self) -> None:
        """Advance the epoch stream as one full iteration would, without
        making a batch: a rank of a mesh that runs none of a family's
        members keeps its loaders where the others' are."""
        self._next_epoch_id()
        if self.shuffle and self._round is None:
            self.rng.shuffle(list(range(len(self.dataset))))

    def _stack(self, samples: List[dict], n_valid: int) -> Dict[str, Any]:
        return stack_samples(samples, n_valid)

    def _epoch_order(self) -> List[int]:
        """Start the next epoch: its row order, with the dataset's
        per-sample augmentation rngs keyed to its epoch id."""
        from creamfl_tpu_torch.data.sample_rng import set_epoch

        order = list(range(len(self.dataset)))
        epoch_id = self._next_epoch_id()
        if self.shuffle:
            # Round mode derives the order from (seed, epoch_id) —
            # identical for a resumed process; the default keeps the
            # legacy sequential stream.
            rng = (random.Random(self.seed * 2_147_483_659 + epoch_id)
                   if self._round is not None else self.rng)
            rng.shuffle(order)
        # Epoch-key the per-sample augmentation rngs (pad refetches then
        # reproduce the row they duplicate).
        set_epoch(self.dataset, epoch_id)
        return order

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return outermost(self._batches())

    def _batches(self) -> Iterator[Dict[str, Any]]:
        order = self._epoch_order()
        # Fast path: a CachedDataset exposes contiguous arrays — one
        # fancy-index per batch instead of n per-sample stacks.
        arrays = (getattr(self.dataset, "arrays", None)
                  if self.collate_fn is None else None)
        for b in range(len(self)):
            idxs, n_valid = batch_indices(order, b, self.batch_size,
                                          self.pad_last)
            if arrays is not None:
                ids = np.asarray(idxs)
                batch = {k: a[ids] for k, a in arrays.items()}
                batch["valid"] = np.arange(len(ids)) < n_valid
                yield batch
                continue
            samples = [self.dataset[i] for i in idxs]
            if self.collate_fn is not None:
                yield self.collate_fn(samples)
            else:
                yield self._stack(samples, n_valid)


class CachedDataset:
    """Materialize an indexable sample-dict dataset into contiguous host
    arrays (one-time cost), so epochs over it are pure memcpy.

    The reference leans on torch DataLoader worker processes for this
    (SURVEY.md L0); this environment is single-core, so paper-scale
    synthetic runs pre-render instead. ``ArrayLoader`` detects the
    ``arrays`` attribute and batches by fancy indexing.
    """

    def __init__(self, dataset, verbose: bool = False):
        n = len(dataset)
        first = dataset[0]
        self.arrays: Dict[str, np.ndarray] = {}
        for k, v in first.items():
            arr = np.asarray(v)
            if arr.dtype == object:
                continue
            self.arrays[k] = np.empty((n,) + arr.shape, arr.dtype)
        for i in range(n):
            sample = dataset[i]
            for k, store in self.arrays.items():
                store[i] = sample[k]
            if verbose and i and i % 10000 == 0:
                print(f"cached {i}/{n}", flush=True)
        self._base = dataset

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, i: int):
        return {k: a[i] for k, a in self.arrays.items()}

    def __getattr__(self, name):  # vocab, targets, iid_to_cls, ...
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["_base"], name)


class PrefetchLoader:
    """Background-thread prefetch over any batch iterable: overlaps host
    batch assembly with device execution (the torch-DataLoader-workers
    role, single-process edition — numpy memcpy releases the GIL)."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def set_round(self, round_n: int) -> None:
        self.loader.set_round(round_n)

    def skip_epoch(self) -> None:
        self.loader.skip_epoch()

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        err: List[BaseException] = []

        def safe_put(item) -> bool:
            """Blocking put that gives up once ``stop`` is set (the
            consumer abandoned the iterator and won't drain the queue)."""
            while True:
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    if stop.is_set():
                        return False

        def fill():
            try:
                for batch in profiling.spanned(self.loader,
                                               "creamfl.data.produce"):
                    if not safe_put(batch) or stop.is_set():
                        return
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                safe_put(sentinel)

        t = threading.Thread(target=fill, daemon=True)
        t.start()

        def drain():
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    profiling.count("data.queue_empty")
                    item = q.get()
                if item is sentinel:
                    return
                yield item

        try:
            yield from outermost(drain())
        finally:
            # A consumer that stops early (next(iter(...)), a sliced
            # epoch) raises GeneratorExit here; without the stop signal
            # the fill thread would block on q.put forever and leak a
            # thread + `depth` buffered batches per abandoned iterator.
            stop.set()
            while True:  # drain so the final q.put(sentinel) can't block
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            # Bounded join: the fill thread notices `stop` between loader
            # items, but an in-flight self.loader.__next__ can block
            # arbitrarily (device sync, slow source) — it's a daemon
            # thread, so let it die on its own rather than stall the
            # consumer.
            t.join(timeout=5.0)
        if err:
            raise err[0]


class ProjectedLoader:
    """Restrict a batch loader to the fields a consumer actually reads.

    A text-client sweep that reads only ``captions``/``lengths`` then
    copies no image batch to the device, and synthesizes or decodes none:
    when ``images`` is not requested and the loader is a device-image
    wrapper (``DeviceImageBatches``, ``data/device_synth.py``, or
    ``DeviceImages``, ``data/device_images.py``), iteration short-circuits
    to its caption-only ``base`` loader. Host-rendered images (the
    synthetic default scale) are still rendered.
    """

    def __init__(self, loader, fields):
        self.loader = loader
        self.fields = tuple(fields)

    def __len__(self):
        return len(self.loader)

    def skip_epoch(self) -> None:
        self.loader.skip_epoch()

    def __iter__(self):
        from creamfl_tpu_torch.data.device_images import DeviceImages
        from creamfl_tpu_torch.data.device_synth import DeviceImageBatches

        src = self.loader
        if isinstance(src, (DeviceImageBatches, DeviceImages)) and (
                "images" not in self.fields):
            src = src.base  # skip device image synthesis or decoding
        for batch in src:
            yield {k: v for k, v in batch.items() if k in self.fields}
