"""Federated non-IID data partitioning.

The port's own copy of the JAX package's ``data/partition.py``: the same
partitions for one seed, and the same pickle cache (read when present,
written when regenerated, never into the packaged frozen artifacts).

Reference semantics (`src/datasets/load_FL_datasets.py:79-129`):
  * ``homo``: random permutation split into equal chunks.
  * ``hetero``: per-class Dirichlet(alpha) proportions with a balancing
    mask (clients already holding >= num_samples/num_clients of data get
    zero share of the next class) and a min-size retry loop
    (10 for cifar100, 3000 for AG_NEWS, 500 otherwise).
  * results cached as pickles ``client_{dataset}_{iid|noniid}.pkl``;
    the reference's committed pickles (its `data_partition/` folder)
    are load-bearing for bit-reproducibility and load directly here.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

_MIN_SIZE = {"cifar100": 10, "AG_NEWS": 3000}


def dirichlet_partition(y: np.ndarray, num_clients: int, alpha: float,
                        min_size_floor: int,
                        rng: np.random.Generator) -> Dict[int, List[int]]:
    num_samples = len(y)
    num_classes = int(y.max()) + 1
    min_size = 0
    while min_size < min_size_floor:
        idx_batch: List[List[int]] = [[] for _ in range(num_clients)]
        for k in range(num_classes):
            idx_k = np.where(y == k)[0]
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, num_clients))
            # Balance: clients already at the per-client quota get nothing.
            proportions = np.array(
                [p * (len(idx_j) < num_samples / num_clients)
                 for p, idx_j in zip(proportions, idx_batch)])
            proportions = proportions / proportions.sum()
            cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            for j, split in enumerate(np.split(idx_k, cuts)):
                idx_batch[j].extend(split.tolist())
            min_size = min(len(idx_j) for idx_j in idx_batch)
    out = {}
    for j in range(num_clients):
        rng.shuffle(idx_batch[j])
        out[j] = idx_batch[j]
    return out


def data_partitioner(dataset: str, num_samples: int, num_clients: int,
                     partition: str = "homo",
                     check_dir: Optional[str] = None,
                     alpha: float = 0.5,
                     y_train: Optional[np.ndarray] = None,
                     seed: int = 2021) -> Dict[int, List[int]]:
    """Reference factory surface. ``check_dir`` enables the pickle cache
    (and transparently consumes the reference's committed pickles)."""
    cache = None
    if check_dir:
        suffix = "_iid.pkl" if partition == "homo" else "_noniid.pkl"
        cache = os.path.join(check_dir, f"client_{dataset}{suffix}")
        if os.path.isfile(cache):
            with open(cache, "rb") as f:
                net_map = pickle.load(f)
            # Reference semantics: the frozen pickle is loaded as-is and
            # the run indexes clients 0..N-1 (load_FL_datasets.py:123-129
            # loads blindly; MMFL only ever touches num_clients entries),
            # so a 10-client pickle serves any smaller run. Only a pickle
            # with FEWER clients than requested is a hard error — there
            # is no reference-sanctioned way to invent the missing ones.
            if len(net_map) < num_clients:
                raise ValueError(
                    f"partition cache {cache!r} holds {len(net_map)} "
                    f"clients but the run wants {num_clients}; delete "
                    "the cache or point check_dir elsewhere")
            if len(net_map) > num_clients:
                net_map = {i: net_map[i] for i in range(num_clients)}
            return net_map

    rng = np.random.default_rng(seed)
    if partition == "homo":
        idxs = rng.permutation(num_samples)
        chunks = np.array_split(idxs, num_clients)
        net_map = {i: chunks[i].tolist() for i in range(num_clients)}
    elif partition == "hetero":
        assert y_train is not None
        # Reference floors (10 / 3000 / 500) assume the full datasets;
        # cap relative to dataset size so scaled-down (synthetic/smoke)
        # runs terminate. At full scale the cap equals the reference
        # value (AG_NEWS: 120000 / (4*10) = 3000).
        floor = min(_MIN_SIZE.get(dataset, 500),
                    max(1, num_samples // (4 * num_clients)))
        net_map = dirichlet_partition(np.asarray(y_train), num_clients,
                                      alpha, floor, rng)
    else:
        raise ValueError(f"unknown partition {partition!r}")

    if cache:
        from creamfl_tpu_torch.data import frozen

        # Never write regenerated partitions into the packaged frozen-
        # artifact directory (e.g. a homo run whose _iid.pkl has no
        # frozen counterpart): the package ships reference bytes only.
        if os.path.abspath(check_dir) != os.path.abspath(
                frozen.partitions_dir()):
            os.makedirs(check_dir, exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(net_map, f)
    return net_map
