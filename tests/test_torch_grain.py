"""The port's worker loader (``data/grain_loaders.py``) vs the JAX
package's ``make_loader(..., backend="grain")``.

The JAX package's grain backend is its ``GrainLoader`` on grain's own
workers where grain is installed, else its ``ArrayLoader``; the first test
asserts which one this host gives. The port's ``GrainLoader``
runs on torch worker processes, and its batches must equal the JAX
loader's at 0 and 2 workers over two epochs: shuffled and unshuffled,
``pad_last`` and ``drop_last``, round mode (``set_round``) and a dataset
that draws from a ``SampleRNG``. The three cases of
``tests/test_grain.py`` run against the port; a worker that raises or dies
and a dataset that will not pickle raise in the consumer. Last, the real
bundle with ``data_backend="grain", num_workers=2`` against the JAX
package's bundle, every loader over two epochs (the pattern of
``test_torch_real_data.py``). The JAX loaders run in-process
(``num_workers=0``): grain's batches do not depend on its worker count,
and each of grain's workers would import JAX again, tens of seconds an
epoch on this host. Tolerance: none (exact equality).
"""

import functools
import os
import threading

import numpy as np
import pytest
import torch

from creamfl_tpu_torch.data import coco
from creamfl_tpu_torch.data.grain_loaders import GrainLoader, make_loader
from creamfl_tpu_torch.data.loaders import ArrayLoader
from creamfl_tpu_torch.data.pipelines import build_real_datasets
from creamfl_tpu_torch.data.sample_rng import SampleRNG
from creamfl_tpu_torch.data.synthetic import SyntheticTextClassification
from torch_cpu_share import torch_cpu_share  # noqa: F401

# The JAX package is imported inside the tests: a worker unpickles this
# module's datasets by importing it, and must not import JAX each epoch.


def _jax():
    from creamfl_tpu.data import grain_loaders, loaders, sample_rng, synthetic

    return grain_loaders, loaders, sample_rng, synthetic


class DrawingSet:
    """Rows whose values come from a per-(index, epoch) ``SampleRNG``
    draw, plus a string field (``rng_cls``: either package's SampleRNG,
    so that either package's loader sets its epoch)."""

    def __init__(self, n, rng_cls):
        self.n = n
        self.rng = rng_cls(7)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = self.rng.for_index(i)
        return {"x": np.float32(r.random()), "k": np.int64(r.getrandbits(40)),
                "index": np.int64(i), "name": f"row{i}"}


class RaisingSet:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        raise ValueError(f"row {i} is broken")


class DyingSet:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        os._exit(3)


class LockedSet(DyingSet):
    def __init__(self):
        self.lock = threading.Lock()  # does not pickle


def _equal(a_batches, b_batches):
    assert len(a_batches) == len(b_batches)
    for a, b in zip(a_batches, b_batches):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], list):
                assert a[k] == b[k], k
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                assert b[k].dtype == np.asarray(a[k]).dtype, k


def test_jax_grain_backend_is_what_this_host_has():
    """Where grain is installed, the JAX package's grain backend is its
    ``GrainLoader`` on grain's workers; elsewhere its ``ArrayLoader``."""
    jgrain, jloaders, _, jsynth = _jax()
    ds = jsynth.SyntheticTextClassification(n=8)
    want = jgrain.GrainLoader if jgrain.HAVE_GRAIN else jloaders.ArrayLoader
    assert type(jgrain.make_loader(ds, 4, backend="grain",
                                   num_workers=2)) is want


CASES = {
    "shuffle_pad": dict(n=19, bs=4, kw=dict(shuffle=True, pad_last=True)),
    "drop_last": dict(n=19, bs=4, kw=dict(shuffle=True, drop_last=True)),
    "ragged_unshuffled": dict(n=10, bs=4, kw=dict(pad_last=False)),
    "round_mode": dict(n=13, bs=5, kw=dict(shuffle=True), round=3),
}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("data", ["text", "draws"])
def test_batches_equal_jax(case, workers, data):
    jgrain, _, jsample_rng, jsynth = _jax()
    c = CASES[case]
    if data == "text":
        jds = jsynth.SyntheticTextClassification(n=c["n"], seed=3)
        tds = SyntheticTextClassification(n=c["n"], seed=3)
    else:
        jds = DrawingSet(c["n"], jsample_rng.SampleRNG)
        tds = DrawingSet(c["n"], SampleRNG)
    jl = jgrain.make_loader(jds, c["bs"], backend="grain", seed=5,
                            num_workers=0, **c["kw"])
    tl = make_loader(tds, c["bs"], backend="grain", seed=5,
                     num_workers=workers, **c["kw"])
    assert type(tl) is (GrainLoader if workers else ArrayLoader)
    assert len(tl) == len(jl)
    if "round" in c:
        jl.set_round(c["round"])
        tl.set_round(c["round"])
    for _ in range(2):
        _equal(list(jl), list(tl))


def test_skip_epoch_keeps_the_stream():
    ds = SyntheticTextClassification(n=11)
    a = ArrayLoader(ds, 4, shuffle=True, seed=2)
    g = GrainLoader(ds, 4, shuffle=True, seed=2)
    for loader in (a, g):
        loader.skip_epoch()
    _equal(list(a), list(g))
    for loader in (a, g):
        loader.set_round(1)
        loader.skip_epoch()
    _equal(list(a), list(g))


# the three cases of tests/test_grain.py, on the port

def test_grain_loader_covers_dataset_once():
    ds = SyntheticTextClassification(n=10)
    ld = GrainLoader(ds, batch_size=4, shuffle=False, num_workers=2)
    batches = list(ld)
    assert len(batches) == len(ld) == 3
    labels = np.concatenate([b["labels"][b["valid"]] for b in batches])
    np.testing.assert_array_equal(labels, ds.targets.astype(np.int32))
    assert batches[-1]["captions"].shape == (4, 16)
    assert batches[-1]["valid"].tolist() == [True, True, False, False]


def test_grain_shuffle_reseeds_per_epoch():
    ds = SyntheticTextClassification(n=16)
    ld = GrainLoader(ds, batch_size=8, shuffle=True, seed=0)
    e1 = [b["labels"].tolist() for b in ld]
    e2 = [b["labels"].tolist() for b in ld]
    assert e1 != e2


def test_make_loader_backend_switch():
    ds = SyntheticTextClassification(n=8)
    assert isinstance(make_loader(ds, 4, backend="array"), ArrayLoader)
    assert isinstance(make_loader(ds, 4, backend="grain", num_workers=2),
                      GrainLoader)
    # No workers: the in-process ArrayLoader itself.
    assert type(make_loader(ds, 4, backend="grain")) is ArrayLoader
    with pytest.raises(ValueError, match="backend"):
        make_loader(ds, 4, backend="tfdata")


# failures raise in the consumer

def test_worker_failures_raise():
    with pytest.raises(ValueError, match="row 0 is broken"):
        list(GrainLoader(RaisingSet(), 3, num_workers=2))
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(GrainLoader(DyingSet(), 3, num_workers=2))
    with pytest.raises(TypeError, match="pickle"):
        list(GrainLoader(LockedSet(), 3, num_workers=2))


# the real bundle

LOADERS = ("pub_train", "pub_eval", "test", "val", "img_clients",
           "txt_clients", "mm_clients", "img_test", "txt_test")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    from test_torch_real_data import ROOTS, _args, _partition_dir

    from creamfl_tpu.data import native as jnative
    from creamfl_tpu.data.pipelines import build_real_datasets as j_build

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(coco, "CocoCaptionsCap",
                   functools.partial(coco.CocoCaptionsCap, native=False))
        jtmp = tmp_path_factory.mktemp("jax")
        ttmp = tmp_path_factory.mktemp("port")
        jax_ds = j_build(_args(jtmp, data_backend="grain"), None,
                         partition_dir=_partition_dir(jtmp), **ROOTS)
        port_ds = build_real_datasets(_args(ttmp, data_backend="grain",
                                            num_workers=2), None,
                                      partition_dir=_partition_dir(ttmp),
                                      device="cpu", **ROOTS)
    return jax_ds, port_ds


@pytest.mark.parametrize("key", LOADERS)
def test_bundle_with_workers_equal_to_jax(bundles, key):
    jax_ds, port_ds = bundles
    jl, tl = jax_ds[key], port_ds[key]
    jl, tl = (jl, tl) if isinstance(jl, list) else ([jl], [tl])
    assert len(jl) == len(tl)
    for tloader in tl:
        base = getattr(tloader, "base", tloader)
        assert isinstance(base, GrainLoader) and base.num_workers == 2
    for _ in range(2):  # two epochs: new orders and new draws
        for jloader, tloader in zip(jl, tl):
            jb, tb = list(jloader), list(tloader)
            assert len(jb) == len(tb) == len(tloader) > 0
            for a, b in zip(jb, tb):
                assert sorted(a) == sorted(b)
                for field in a:
                    got = b[field]
                    got = got.numpy() if isinstance(got, torch.Tensor) \
                        else np.asarray(got)
                    np.testing.assert_array_equal(
                        got, np.asarray(a[field]), err_msg=f"{key}/{field}")


# no process outlives its starter

def test_worker_server_stops_with_the_sweep():
    """``chip_smoke.stop_children`` (the script's last step) stops the
    worker server through ``stop_worker_server`` and waits for it, and
    signals what else is left; afterwards no process of this one runs,
    and a later epoch starts a new server with the same batches."""
    import subprocess
    from multiprocessing import forkserver

    import chip_smoke

    ds = SyntheticTextClassification(n=8)
    ld = GrainLoader(ds, batch_size=4, num_workers=2)
    first = list(ld)
    server = forkserver._forkserver._forkserver_pid
    assert server in chip_smoke._descendants(os.getpid())
    sleeper = subprocess.Popen(["sleep", "60"])
    stopped = chip_smoke.stop_children(grace=5.0)
    assert sleeper.poll() is not None and sleeper.pid in stopped
    assert server not in stopped and not chip_smoke._alive(server)
    assert not [p for p in chip_smoke._descendants(os.getpid())
                if chip_smoke._alive(p)]
    _equal(first, list(ld))
    assert forkserver._forkserver._forkserver_pid not in (None, server)
