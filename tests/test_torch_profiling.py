"""The port's tracing (``utils/profiling.py``) on the CPU.

* The recorder off: ``span`` is one shared no-op context and ``count``
  returns at once, with no allocation a span and no clock read.
* The recorder on: nesting and parents, spans of one name nested on a
  thread counted once, threads, counters under contention, the cap.
* One clock with ``torch.profiler``: a span brackets the ranges the CPU
  profiler records inside it, and opens a ``record_function`` range of its
  name only while recording.
* The loaders: ``creamfl.data.next`` once a batch on the consuming thread,
  through ``PrefetchLoader`` (whose thread's work is ``data.produce``) and a
  loader nested in another.
* A smoke server epoch: one ``creamfl.engine.*`` span of each kind a step,
  ``engine.steps`` equal to AdamP's steps.
* ``device_split`` on hand-made profiler events.
* ``main.py --trace_dir``: a one-round smoke run writes a loadable Chrome
  trace-event file holding the round's phases.
"""

import json
import os
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from creamfl_tpu_torch.data.loaders import ArrayLoader, PrefetchLoader
from creamfl_tpu_torch.utils import profiling as P
from torch_cpu_share import torch_cpu_share  # noqa: F401

ENGINE = ("stage", "forward", "loss", "backward", "update")


class _Rows:
    """A dataset of ``n`` rows as contiguous arrays (ArrayLoader's fast
    path)."""

    def __init__(self, n):
        self.arrays = {"x": np.arange(2 * n).reshape(n, 2)}

    def __len__(self):
        return len(self.arrays["x"])


def test_off_records_nothing(monkeypatch):
    assert not P.active()
    assert P.span("creamfl.a") is P.span("creamfl.b")
    names = ["creamfl.x"] * 10_000
    for name in names[:100]:  # warm
        with P.span(name):
            P.count(name)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for name in names:
            with P.span(name):
                P.count(name)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    # A one-off byte count, not one a span: 10 000 spans.
    assert peak - base < 1024

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(P.time, "time_ns", no_clock)
    with P.span("creamfl.a"):
        P.count("c", 3)
    monkeypatch.undo()
    with P.recording() as snap:
        pass
    assert snap.spans == [] and snap.counters == {}


def test_nesting_parents_and_counts():
    with P.recording() as snap:
        with P.span("creamfl.a"):
            with P.span("creamfl.b"):
                with P.span("creamfl.a"):
                    time.sleep(0.002)
            P.count("c")
        P.count("c", 4)
    assert not P.active()
    by_name = {}
    for s in snap.spans:
        by_name.setdefault(s.name, []).append(s)
    (b,) = by_name["creamfl.b"]
    outer, inner = sorted(by_name["creamfl.a"], key=lambda s: s.start_ns)
    assert outer.parent is None and b.parent == "creamfl.a"
    assert inner.parent == "creamfl.b"
    assert outer.start_ns <= b.start_ns <= inner.start_ns
    assert inner.end_ns <= b.end_ns <= outer.end_ns
    # The inner "a" is inside the outer one: counted once.
    assert snap.counts == {"creamfl.a": 1, "creamfl.b": 1}
    assert snap.seconds["creamfl.a"] == pytest.approx(
        (outer.end_ns - outer.start_ns) / 1e9)
    assert snap.counters == {"c": 5}
    assert {s.thread for s in snap.spans} == {snap.thread}
    assert snap.start_ns <= outer.start_ns and outer.end_ns <= snap.end_ns
    with pytest.raises(RuntimeError, match="on already"):
        with P.recording():
            with P.recording():
                pass


def test_threads_and_counters_under_contention():
    """More threads than cores, a short switch interval: no count is lost
    and each thread's spans carry its own id."""
    workers, each = 2 * (os.cpu_count() or 2), 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ids = []
    try:
        with P.recording() as snap:
            def work():
                ids.append(threading.get_native_id())
                for _ in range(each):
                    with P.span("creamfl.t"):
                        P.count("n")

            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert snap.counters["n"] == workers * each
    assert snap.counts["creamfl.t"] == workers * each
    assert set(snap.by_thread) == set(ids)
    assert snap.on_thread("creamfl.t") == 0.0
    assert sum(d["creamfl.t"] for d in snap.by_thread.values()) == (
        pytest.approx(snap.seconds["creamfl.t"]))


def test_cap_keeps_the_totals():
    with P.recording(cap=3) as snap:
        for _ in range(5):
            with P.span("creamfl.x"):
                pass
    assert len(snap.spans) == 3 and snap.dropped == 2
    assert snap.counts["creamfl.x"] == 5


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.profiler.kineto_results.events())


def test_spans_share_the_profilers_clock():
    from torch.profiler import record_function

    def work():
        with P.span("creamfl.outer"):
            time.sleep(0.001)
            with record_function("inner"):
                x = torch.randn(64, 64)
                (x @ x).relu().sum()
            time.sleep(0.001)

    with P.recording() as snap:
        events = _profiled(work)
    (sp,) = snap.spans
    inside = [e for e in events if e.name() in ("inner", "aten::mm")]
    assert len(inside) == 2
    for e in inside:
        assert sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns
    # The span's own range, on the same clock, within the span.
    (rf,) = [e for e in events if e.name() == "creamfl.outer"]
    assert sp.start_ns <= rf.start_ns() <= rf.end_ns() <= sp.end_ns
    assert (rf.end_ns() - rf.start_ns()) / (sp.end_ns - sp.start_ns) > 0.9


def test_ranges_only_while_recording():
    def work():
        with P.span("creamfl.r"):
            torch.ones(8).sum()

    off = _profiled(work)
    assert not [e for e in off if e.name().startswith("creamfl.")]
    with P.recording():
        on = _profiled(work)
    assert [e.name() for e in on if e.name().startswith("creamfl.")] == [
        "creamfl.r"]


def test_data_next_once_a_batch():
    from creamfl_tpu_torch.data.device_synth import (DeviceImageBatches,
                                                     DeviceImageSynth)

    loaders = {"array": ArrayLoader(_Rows(22), 4),
               "prefetch": PrefetchLoader(ArrayLoader(_Rows(22), 4), 2)}
    for name, loader in loaders.items():
        with P.recording() as snap:
            n = sum(1 for _ in loader)
        assert n == 6
        assert snap.counts["creamfl.data.next"] == n, name
        assert snap.counters["data.batches"] == n
        assert snap.on_thread("creamfl.data.next") == pytest.approx(
            snap.seconds["creamfl.data.next"])
        produced = snap.counts.get("creamfl.data.produce", 0)
        assert produced == (n if name == "prefetch" else 0)
        assert snap.on_thread("creamfl.data.produce") == 0.0
    # A loader inside another on one thread: the outer one's next() only.
    nested = [s for s in snap.spans if s.name == "creamfl.data.next"
              and s.parent is not None]
    assert nested == []

    class _Ids:
        arrays = {"image_ids": np.arange(12)}

        def __len__(self):
            return 12

    synth = DeviceImageSynth(8, seed=0, n_concepts=3, device="cpu")
    wrapped = DeviceImageBatches(PrefetchLoader(ArrayLoader(_Ids(), 4)),
                                 synth, lambda i: i % 3)
    with P.recording() as snap:
        batches = list(wrapped)
    assert len(batches) == 3 and batches[0]["images"].shape == (4, 8, 8, 3)
    assert snap.counts["creamfl.data.next"] == 3
    assert snap.counts["creamfl.data.produce"] == 3
    assert all(s.parent is None for s in snap.spans)


@pytest.fixture(scope="module")
def smoke_round(tmp_path_factory):
    """An ``MMFL`` at the CLI's smoke sizes with no clients (the server
    alone), built as ``main.run`` builds it."""
    from creamfl_tpu_torch import main
    from creamfl_tpu_torch.federation.rounds import MMFL
    from creamfl_tpu_torch.utils.helper import set_seed

    args = main.parse_args([
        "--no-cuda", "--synthetic", "--smoke", "--num_img_clients", "0",
        "--num_txt_clients", "0", "--num_mm_clients", "0",
        "--client_num_per_round", "0", "--no_mesh", "--seed", "3",
        "--exp_dir", str(tmp_path_factory.mktemp("exp"))])
    set_seed(args.seed)
    server_cfg, mm_cfg, bert_cfg = main.build_configs(args)
    datasets = main.build_datasets(args, torch.device("cpu"))
    return MMFL(args, datasets, server_cfg, mm_cfg, bert_config=bert_cfg,
                device="cpu")


def test_server_epoch_spans(smoke_round):
    algo = smoke_round
    loader = algo.datasets["pub_train"]
    algo.datasets["pub_train"] = PrefetchLoader(loader, 2)
    opt = algo.server_state.optimizer
    try:
        with P.recording() as snap:
            algo._server_train_epoch()
    finally:
        algo.datasets["pub_train"] = loader
    steps = max(int(st["step"]) for st in opt.state.values())
    assert steps == len(loader) > 1
    assert snap.counters["engine.steps"] == steps
    assert snap.counters["engine.rows"] == steps * loader.batch_size
    for kind in ENGINE:
        assert snap.counts[f"creamfl.engine.{kind}"] == steps, kind
        assert snap.on_thread(f"creamfl.engine.{kind}") > 0.0
    assert snap.counts["creamfl.data.next"] == steps
    assert snap.counters["data.batches"] == steps
    assert snap.on_thread("creamfl.data.next") == pytest.approx(
        snap.seconds["creamfl.data.next"])
    assert snap.counts["creamfl.data.produce"] == steps
    # The step spans follow one another on the phase thread.
    parents = {s.parent for s in snap.spans
               if s.name.startswith("creamfl.engine.")}
    assert parents == {None}
    assert snap.counters.get("ops.builds", 0) == 0
    assert snap.counters.get("graph.captures", 0) == 0


class Ev:
    """A raw profiler event as ``device_split`` reads it."""

    def __init__(self, name, s, t, dev="cpu", corr=0, tid=1, ann=False):
        self._v = (name, s, t, dev, corr, tid, ann)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        cuda = torch.autograd.DeviceType
        return cuda.CUDA if self._v[3] == "cuda" else cuda.CPU

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_device_split_by_span():
    events = [
        Ev("call", 0, 1000, ann=True),
        Ev("creamfl.data.next", 0, 100, ann=True),
        Ev("creamfl.engine.forward", 100, 300, ann=True),
        Ev("cudaLaunchKernel", 110, 112, corr=1),
        Ev("creamfl.engine.backward", 300, 600, ann=True),
        # autograd's own thread launches the backward's kernel
        Ev("cudaLaunchKernel", 320, 322, corr=2, tid=2),
        Ev("creamfl.engine.update", 600, 900, ann=True),
        Ev("creamfl.ops.build", 650, 700, ann=True),
        Ev("cudaLaunchKernel", 660, 662, corr=3),
        Ev("cudaLaunchKernel", 950, 952, corr=4),
        # a range on another thread covers no idle of the call's thread
        Ev("creamfl.data.produce", 0, 1000, tid=3, ann=True),
        Ev("fwd", 150, 250, "cuda", corr=1),
        Ev("bwd", 330, 500, "cuda", corr=2),
        Ev("upd", 700, 800, "cuda", corr=3),
        Ev("tail", 960, 1100, "cuda", corr=4),
        Ev("annotation", 0, 1000, "cuda", ann=True),
    ]
    split = P.device_split(events, "call")
    assert split.wall_s == pytest.approx(1000e-9)
    # busy: 100 + 170 + 100 + 40 (clipped at the call's end)
    assert split.busy_s == pytest.approx(410e-9)
    assert split.device_s["creamfl.engine.forward"] == pytest.approx(100e-9)
    assert split.device_s["creamfl.engine.backward"] == pytest.approx(
        170e-9)
    assert split.device_s["creamfl.engine.update"] == pytest.approx(100e-9)
    assert split.device_s["creamfl.ops.build"] == pytest.approx(100e-9)
    assert "creamfl.data.produce" not in split.device_s
    # idle by innermost span on the call's thread
    want = {"creamfl.data.next": 100, "creamfl.engine.forward": 100,
            "creamfl.engine.backward": 130, "creamfl.engine.update": 150,
            "creamfl.ops.build": 50, "": 60}
    assert split.idle_s == pytest.approx({k: v * 1e-9
                                          for k, v in want.items()})
    assert sum(split.idle_s.values()) == pytest.approx(
        split.wall_s - split.busy_s)
    with pytest.raises(RuntimeError, match="no range"):
        P.device_split(events, "other")


def test_trace_dir_writes_the_rounds_spans(tmp_path):
    from creamfl_tpu_torch import main

    trace_dir = tmp_path / "spans"
    args = main.parse_args([
        "--no-cuda", "--synthetic", "--smoke", "--comm_rounds", "1",
        "--local_epochs", "1", "--num_img_clients", "1",
        "--num_txt_clients", "0", "--num_mm_clients", "0",
        "--client_num_per_round", "1", "--agg_method", "con_w",
        "--no_mesh", "--seed", "0", "--exp_dir", str(tmp_path / "exp"),
        "--name", "traced", "--trace_dir", str(trace_dir)])
    algo = main.run(args)
    assert not P.active()
    assert sorted(os.listdir(trace_dir)) == ["round1.spans.json"]
    with open(trace_dir / "round1.spans.json") as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    phases = {"round", "server_train", "global_features", "clients_img",
              "aggregate_distill", "eval"}
    assert {f"creamfl.round.{p}" for p in phases} <= names
    assert {f"creamfl.engine.{k}" for k in ENGINE} <= names
    assert "creamfl.data.next" in names
    (rnd,) = [e for e in spans if e["name"] == "creamfl.round.round"]
    for e in spans:
        if e["tid"] == rnd["tid"]:
            assert rnd["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                             <= rnd["ts"] + rnd["dur"] + 1)
    # On the profiler's clock (Unix-epoch microseconds), around the run.
    assert abs(rnd["ts"] / 1e6 - time.time()) < 3600
    assert rnd["dur"] / 1e6 == pytest.approx(algo.last_timing["round_s"],
                                             abs=0.01)
    counters = {e["name"]: e["args"]["value"]
                for e in trace["traceEvents"] if e["ph"] == "C"}
    assert counters["engine.steps"] > 0 and counters["data.batches"] > 0
