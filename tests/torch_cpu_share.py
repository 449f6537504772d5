"""Each test worker's share of the host's cores for torch's CPU ops.

pytest-xdist runs several workers at once, and torch runs its CPU ops on
one intra-op thread per core by default, so the workers together would
spin workers x cores threads on the cores. A port test module imports
``torch_cpu_share`` (one line) and its tests then run on the cores
divided by the workers, at least one; run alone, a module keeps every
core. A module fixture that pinned fewer threads before this one (one
thread, for determinism) keeps its count. ``OMP_NUM_THREADS`` carries the
same count to the processes the module starts. Both are restored when
the module ends.
"""

import os

import pytest
import torch


def cpu_share() -> int:
    """The host's cores (this process's affinity) over the xdist workers,
    at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_share():
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    share = min(cpu_share(), threads)
    torch.set_num_threads(share)
    os.environ["OMP_NUM_THREADS"] = str(share)
    try:
        yield share
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
