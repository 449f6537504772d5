"""The multi-worker batch loader behind ``--data_backend grain``.

Port of the JAX package's ``data/grain_loaders.py``. The module keeps its
name because ``grain`` stays the CLI's value, but it runs on
``torch.utils.data`` worker processes, not on Google Grain.

Batch composition: ``GrainLoader`` is an ``ArrayLoader`` whose epochs run
on a worker pool. Each record of the pool is one whole stacked batch
(``_BatchView``) over the epoch order ``ArrayLoader`` computes
(``_epoch_order``: the stateful shuffle stream, or round mode's
``(seed, epoch id)``), padded by the same ``batch_indices``, so the
workers share batch assembly out while the pool hands the batches back in
order: for any worker count the batches equal the array backend's, field
for field.

Workers: each epoch starts ``num_workers`` fresh processes from a
``forkserver`` (a server process started once, which has imported this
module, and so torch and numpy; CUDA, NCCL and the prefetch threads of the
parent are never forked). The server is stopped, and waited for, when the
process exits (``stop_worker_server``), so that no process of the loader
outlives it. The epoch is set on the dataset before the pool
starts (``_epoch_order`` calls ``sample_rng.set_epoch``), and the pool
pickles the dataset into each worker, so every worker draws the epoch's
augmentations. Everything a
dataset holds must pickle, and no worker may touch CUDA: the readers
return image recipes, and ``DeviceImages`` decodes and transforms them on
the device in the main process, above this loader. A dataset that will
not pickle, or a worker that dies, raises in the consumer: there is no
fallback to in-process loading. ``make_loader`` gives the plain
``ArrayLoader`` for ``num_workers=0``.

Batches stay dict-of-ndarray (string fields lists of str), as
``ArrayLoader``'s: the pool gets ``batch_size=None`` and an identity
``collate_fn``, so torch's default collation, which would turn arrays into
tensors, never runs.
"""

from __future__ import annotations

import atexit
import multiprocessing
from multiprocessing import forkserver
from typing import Any, Dict, Sequence

from torch.utils.data import DataLoader

from creamfl_tpu_torch.data.loaders import (ArrayLoader, batch_indices,
                                            outermost, stack_samples)


class _BatchView:
    """Indexable view whose record ``b`` is the ready-stacked batch ``b``
    of an epoch's ``order``, with ArrayLoader's pad and ``valid``
    semantics (``batch_indices``)."""

    def __init__(self, dataset, order: Sequence[int], n_batches: int,
                 batch_size: int, pad_last: bool):
        self.dataset = dataset
        self.order = order
        self.n_batches = n_batches
        self.batch_size = batch_size
        self.pad_last = pad_last

    def __len__(self) -> int:
        return self.n_batches

    def __getitem__(self, b) -> Dict[str, Any]:
        idxs, n_valid = batch_indices(self.order, int(b), self.batch_size,
                                      self.pad_last)
        return stack_samples([self.dataset[i] for i in idxs], n_valid)


def _identity(batch):
    """The pool's ``collate_fn``: a record is already a batch."""
    return batch


#: What the worker server imports once besides the main module and this
#: one, so that no worker imports it again each epoch: the readers whose
#: datasets the real-data bundle gives the pool, and nltk's Treebank
#: tokenizer, which their captions go through (three seconds to import;
#: skipped where nltk is missing).
PRELOAD = ("creamfl_tpu_torch.data.agnews", "creamfl_tpu_torch.data.cifar",
           "creamfl_tpu_torch.data.coco", "creamfl_tpu_torch.data.cub",
           "creamfl_tpu_torch.data.flickr30k",
           "creamfl_tpu_torch.data.pipelines", "nltk.tokenize.treebank")


def _worker_context():
    """The ``forkserver`` context. The server imports the main module, this
    one (and so torch and ``torch.utils.data``) and ``PRELOAD`` once, so
    that a worker starts without importing them again. As under ``spawn``,
    the main module must guard its entry point with ``if __name__ ==
    "__main__"``."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", __name__, *PRELOAD])
    return ctx


def stop_worker_server() -> None:
    """Stops the worker server, if one runs, and waits for it to exit: left
    alone it outlives this process by the second its interpreter takes to
    shut down (it imported torch). Runs at exit; a later loader epoch
    starts a new server."""
    # multiprocessing has no public call for this: ``_stop`` is the one its
    # own tests use.
    forkserver._forkserver._stop()


atexit.register(stop_worker_server)


class GrainLoader(ArrayLoader):
    """``ArrayLoader`` whose epochs are assembled by a pool of
    ``num_workers`` worker processes (in the main process for 0)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, pad_last: bool = True,
                 seed: int = 2021, num_workers: int = 0):
        super().__init__(dataset, batch_size, shuffle=shuffle,
                         drop_last=drop_last, pad_last=pad_last, seed=seed)
        self.num_workers = int(num_workers)

    def __iter__(self):
        if self.num_workers == 0:
            return super().__iter__()
        # Before the pool starts: it pickles the dataset into its workers.
        view = _BatchView(self.dataset, self._epoch_order(), len(self),
                          self.batch_size, self.pad_last)
        return outermost(DataLoader(
            view, batch_size=None, shuffle=False,
            num_workers=self.num_workers, collate_fn=_identity,
            multiprocessing_context=_worker_context(),
            persistent_workers=False))


def make_loader(dataset, batch_size: int, backend: str = "array", **kwargs):
    """backend: "array" (``ArrayLoader``, in-process) or "grain"
    (``GrainLoader``, ``num_workers`` worker processes; ``ArrayLoader``
    for none)."""
    if backend not in ("array", "grain"):
        raise ValueError(f"unknown data backend {backend!r}")
    if backend == "grain" and kwargs.get("num_workers"):
        kwargs.pop("collate_fn", None)
        return GrainLoader(dataset, batch_size, **kwargs)
    kwargs.pop("num_workers", None)
    return ArrayLoader(dataset, batch_size, **kwargs)
