"""The port's tracing: spans and counters inside the program, and the
round's per-phase wall-clock timers.

``span(name)`` marks a block and ``count(name, n)`` adds to a counter;
``tally(name, t)`` adds a device scalar to a counter kept on the device.
They go to one process-wide recorder that is off by default: while it is off,
``span`` returns one shared no-op context and ``count`` returns at once (no
allocation, no lock, no clock read). ``recording()`` turns it on for a
block and hands back a ``Snapshot`` when the block closes. No span or
counter synchronises the device: a tally is one in-place add on the device
while the recorder is on, read to the host once, when the recording closes
(not inside a CUDA graph's capture, so a replay does not add to it).

While the recorder is on, each span records its name, the span it opened
in (its parent, on its own thread), its thread and its start and end in
Unix-epoch nanoseconds (``time.time_ns()``), the clock of
``torch.profiler``'s raw events. Where a ``torch.profiler`` is active as
well, each span also opens a ``record_function`` range of its name, so
that the spans sit in the profiler's timeline beside the kernels they
launched; ``device_split`` reduces such a profile by span. Program span
names start with ``creamfl.``:

* ``creamfl.round.<phase>``: ``StepTimer.phase``;
* ``creamfl.data.next`` (the consuming thread's wait in the outermost
  loader's ``next()``) and ``creamfl.data.produce`` (a prefetch thread's
  work a batch): ``data/loaders.py``;
* ``creamfl.engine.{stage,forward,loss,backward,update}``:
  ``engine/server.py``;
* ``creamfl.graph.capture``: ``engine/graphs.py``;
* ``creamfl.ops.build``: ``ops/build.py``;
* ``creamfl.mla.attend`` and ``creamfl.moe.{route,experts,combine}``:
  ``models/deepseek_v2.py``.

Counters: ``data.batches``, ``data.queue_empty``, ``engine.steps``,
``engine.rows``, ``moe.tokens`` and ``moe.pairs`` (the tokens the MoE
layers of a train or distill step routed and their token-expert pairs,
counted where the step returns), ``graph.captures``, ``graph.replays``,
``ops.builds``, ``cuda.device_allocs``, ``bn.single_pass`` (each
train-mode BatchNorm forward, off a mesh, that moved its running stats from
the normalisation's own statistics), ``bn.fused.<epilogue>`` (each
train-mode call of ``models/resnet.py:bn_act`` off a mesh on K8, or on
the CPU's chain: "none", "relu", "add_relu"), the device tally
``moe.held_pairs`` (the pairs the held experts computed, every MoE
forward), and the kernel wrappers' own launch counters read
into the snapshot as ``ops.<wrapper>.<route>``.

``StepTimer`` collects named phase times and reports them. On a CUDA device
(the default) each phase starts and ends with ``torch.cuda.synchronize()``,
so asynchronous kernel launches are charged to the phase that made them.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import torch

from creamfl_tpu_torch.utils.device import resolve_device

PREFIX = "creamfl."
# Spans kept one by one per recording; past it only the totals grow.
MAX_SPANS = 100_000

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    thread: int  # the OS thread id (threading.get_native_id)
    start_ns: int
    end_ns: int


class _Recorder:
    def __init__(self, cap: int):
        self.cap = cap
        self.lock = threading.Lock()
        self.seconds: Dict[Tuple[int, str], float] = defaultdict(float)
        self.counts: Dict[Tuple[int, str], int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.spans: List[Span] = []
        self.dropped = 0
        self.tallies: Dict[str, torch.Tensor] = {}

    def add(self, span: Span, outermost: bool) -> None:
        key = (span.thread, span.name)
        with self.lock:
            if outermost:
                self.seconds[key] += (span.end_ns - span.start_ns) / 1e9
                self.counts[key] += 1
            if len(self.spans) < self.cap:
                self.spans.append(span)
            else:
                self.dropped += 1


_recorder: Optional[_Recorder] = None


class _Thread(threading.local):
    """This thread's open spans, and how many of each name are open."""

    def __init__(self):
        self.id = threading.get_native_id()
        self.stack: List["_Open"] = []
        self.open: Dict[str, int] = defaultdict(int)


_thread = _Thread()


class _Open:
    """One span while it is open (the recorder is on)."""

    __slots__ = ("rec", "name", "parent", "start", "rf")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        th = _thread
        stack = th.stack
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        th.open[self.name] += 1
        self.start = time.time_ns()
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        th = self._close()
        self.rec.add(Span(self.name, self.parent, th.id, self.start, end),
                     th.open[self.name] == 0)
        return False

    def _close(self) -> _Thread:
        th = _thread
        if th.stack[-1] is self:
            th.stack.pop()
        else:
            th.stack.remove(self)
        th.open[self.name] -= 1
        return th


def span(name: str):
    """A context that records the block as span ``name`` while the
    recorder is on; the shared no-op context while it is off."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Open(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    rec = _recorder
    if rec is None:
        return
    with rec.lock:
        rec.counters[name] += n


def tally(name: str, value: torch.Tensor) -> None:
    """Add the 0-d tensor ``value`` to counter ``name`` while the recorder
    is on, on ``value``'s device (no host read; none while a CUDA graph is
    being captured)."""
    rec = _recorder
    if rec is None or (value.is_cuda
                       and torch.cuda.is_current_stream_capturing()):
        return
    with rec.lock:
        acc = rec.tallies.get(name)
        if acc is None:
            acc = rec.tallies[name] = torch.zeros(
                (), dtype=torch.int64, device=value.device)
    acc.add_(value)


def active() -> bool:
    return _recorder is not None


def spanned(items: Iterable, name: str, unless: Optional[str] = None,
            counter: Optional[str] = None) -> Iterator:
    """``items``' items, each ``next()`` that yields one inside span
    ``name`` (the ``next()`` that ends the iteration is not a span), and
    counted in ``counter``; no span where ``unless`` prefixes a span open on
    this thread at that ``next()`` (an outer loader already times it)."""
    it = iter(items)
    while True:
        rec = _recorder
        opened = None
        if rec is not None and not (unless and any(
                s.name.startswith(unless) for s in _thread.stack)):
            opened = _Open(rec, name)
            opened.__enter__()
        try:
            item = next(it)
        except StopIteration:
            if opened is not None:
                _discard(opened)
            return
        except BaseException as e:
            if opened is not None:
                opened.__exit__(type(e), e, e.__traceback__)
            raise
        if opened is not None:
            opened.__exit__(None, None, None)
            if counter:
                count(counter)
        yield item


def _discard(opened: _Open) -> None:
    """Close an open span without recording it."""
    if opened.rf is not None:
        opened.rf.__exit__(None, None, None)
    opened._close()


@dataclasses.dataclass
class Snapshot:
    """What one recording saw. ``seconds`` and ``counts`` are per span
    name over every thread, parent-aware: a span inside a span of its own
    name on its thread is not counted again; ``by_thread`` splits them by
    thread. ``thread`` is the thread that recorded (the phase thread);
    ``spans`` the spans one by one, up to the cap (``dropped`` past it)."""

    thread: int = 0
    start_ns: int = 0
    end_ns: int = 0
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_thread: Dict[int, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    spans: List[Span] = dataclasses.field(default_factory=list)
    dropped: int = 0

    def on_thread(self, name: str, thread: Optional[int] = None) -> float:
        """Seconds of span ``name`` on ``thread`` (the phase thread)."""
        t = self.thread if thread is None else thread
        return self.by_thread.get(t, {}).get(name, 0.0)

    def chrome_trace(self) -> Dict:
        """The spans as complete events and the counters as counter events
        of the Chrome trace-event format (microseconds on the profiler's
        clock, this process's id), loadable by Perfetto and
        ``chrome://tracing``."""
        pid = os.getpid()
        events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
                   "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
                   "tid": s.thread, "args": {"parent": s.parent}}
                  for s in self.spans]
        events += [{"name": k, "ph": "C", "ts": self.end_ns / 1e3,
                    "pid": pid, "args": {"value": v}}
                   for k, v in sorted(self.counters.items())]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"seconds": self.seconds, "counts": self.counts,
                              "dropped": self.dropped}}


def _launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters by ``ops.<wrapper>.<route>``."""
    from creamfl_tpu_torch.ops import launch_wrappers

    return {f"ops.{fn.__name__}.{route}": n for fn in launch_wrappers()
            for route, n in getattr(fn, "launches_by_route", {}).items()}


@contextlib.contextmanager
def recording(cap: int = MAX_SPANS) -> Iterator[Snapshot]:
    """The recorder on for the block; the ``Snapshot`` yielded is filled
    when the block closes. Recordings do not nest."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("the recorder is on already")
    snap = Snapshot(thread=threading.get_native_id())
    launches = _launches()
    rec = _recorder = _Recorder(cap)
    snap.start_ns = time.time_ns()
    try:
        yield snap
    finally:
        _recorder = None
        snap.end_ns = time.time_ns()
        after = _launches()
        with rec.lock:
            for (thread, name), s in rec.seconds.items():
                snap.seconds[name] = snap.seconds.get(name, 0.0) + s
                snap.counts[name] = (snap.counts.get(name, 0)
                                     + rec.counts[(thread, name)])
                snap.by_thread.setdefault(thread, {})[name] = s
            snap.counters = dict(rec.counters)
            snap.spans, snap.dropped = list(rec.spans), rec.dropped
            tallies = dict(rec.tallies)
        snap.counters.update({k: int(t) for k, t in tallies.items()})
        snap.counters.update({k: n - launches.get(k, 0)
                              for k, n in after.items()
                              if n != launches.get(k, 0)})


# -- a profile reduced by span ---------------------------------------------
_BACKWARD = PREFIX + "engine.backward"
_RUNTIME = ("cuda", "cu")  # the CUDA API calls that launch work


@dataclasses.dataclass
class DeviceSplit:
    """A profiled call reduced by program span (seconds). ``device_s``: per
    span name, the device time of the kernels launched inside a span of
    that name on the launching thread (for ``creamfl.engine.backward``,
    inside its interval on any thread: autograd launches the backward's
    kernels from its own thread). ``idle_s``: the call's device-idle
    seconds split by the innermost program span open on the call's thread
    ("" where none is), so they sum to ``wall_s - busy_s``."""

    wall_s: float
    busy_s: float
    device_s: Dict[str, float]
    idle_s: Dict[str, float]


def _intervals_union(spans: List[Tuple[int, int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _innermost(spans: List[Tuple[int, int, str]], t0: int, t1: int
               ) -> List[Tuple[int, int, str]]:
    """[t0, t1] cut into pieces, each with the innermost of the nested
    ``spans`` open over it ("" for none)."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    cur = t0

    def emit(upto: int) -> None:
        nonlocal cur
        upto = min(max(upto, t0), t1)
        if upto > cur:
            out.append((cur, upto, stack[-1][1] if stack else ""))
            cur = upto

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(t1)
    return out


def device_split(events, call: str) -> DeviceSplit:
    """Reduce a profile's raw events (``prof.profiler.kineto_results
    .events()``) over the range named ``call`` by the program's spans,
    which were recorded while it ran (``recording()``)."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device, launches = [], {}
    ranges: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for e in events:
        name, s, t = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((s, t, e.correlation_id()))
            continue
        if name == call:
            window = (s, t, e.start_thread_id())
        elif name.startswith(PREFIX):
            ranges[e.start_thread_id()].append((s, t, name))
        elif name.startswith(_RUNTIME):
            launches[e.correlation_id()] = (s, e.start_thread_id())
    if window is None:
        raise RuntimeError(f"the profile holds no range {call!r}")
    t0, t1, thread = window
    backward = _intervals_union([(s, t) for r in ranges.values()
                                 for s, t, n in r if n == _BACKWARD])
    back_starts = [s for s, _ in backward]
    by_thread = {tid: (sorted(r), [s for s, _, _ in sorted(r)])
                 for tid, r in ranges.items()}
    device_s: Dict[str, float] = defaultdict(float)
    busy = []
    for s, t, corr in device:
        s, t = max(s, t0), min(t, t1)
        if t <= s:
            continue
        busy.append((s, t))
        launch = launches.get(corr)
        if launch is None:
            continue
        at, tid = launch
        names = set()
        items, starts = by_thread.get(tid, ((), ()))
        i = bisect.bisect_right(starts, at)
        for a, b, n in items[max(0, i - 64):i]:
            if b >= at and n != _BACKWARD:
                names.add(n)
        j = bisect.bisect_right(back_starts, at) - 1
        if j >= 0 and backward[j][1] >= at:
            names.add(_BACKWARD)
        for n in names:
            device_s[n] += (t - s) / 1e9
    merged = _intervals_union(busy)
    edges = [t0] + [x for m in merged for x in m] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_s: Dict[str, float] = defaultdict(float)
    pieces = _innermost(ranges.get(thread, []), t0, t1)
    k = 0
    for a, b in gaps:
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            s, t, n = pieces[j]
            idle_s[n] += (min(t, b) - max(s, a)) / 1e9
            j += 1
    return DeviceSplit(wall_s=(t1 - t0) / 1e9,
                       busy_s=sum(t - s for s, t in merged) / 1e9,
                       device_s=dict(device_s), idle_s=dict(idle_s))


class StepTimer:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._open = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_allocs(self) -> Optional[int]:
        """The allocator's device allocations so far, read only while the
        recorder is on, on the card, at the outermost phase."""
        if self._open or not active() or self.device.type != "cuda":
            return None
        return torch.cuda.memory_stats(self.device).get("num_device_alloc",
                                                        0)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block as phase ``name``, a ``creamfl.round.<name>``
        span between the two synchronisations."""
        self._sync()
        t0 = time.perf_counter()
        allocs = self._device_allocs()
        self._open += 1
        try:
            with span(f"{PREFIX}round.{name}"):
                try:
                    yield
                finally:
                    self._sync()
        finally:
            self._open -= 1
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            end = self._device_allocs() if allocs is not None else None
            if end is not None:
                count("cuda.device_allocs", end - allocs)

    def report(self) -> Dict[str, float]:
        """{phase_s: total seconds, phase_n: count}; clears the totals."""
        summary = {}
        for k, v in self.totals.items():
            summary[f"{k}_s"] = round(v, 3)
            summary[f"{k}_n"] = self.counts[k]
        self.totals.clear()
        self.counts.clear()
        return summary
