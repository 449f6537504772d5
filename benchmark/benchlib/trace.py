"""One phase call under ``torch.profiler``, reduced to what the per-layer
readers take.

The interval arithmetic is ``chip_smoke.py:profile_call``'s: the device's
busy time is the union of the device events' intervals (kernels, copies,
sets), its idle share one minus that over the call's wall time. The wall
time is the span of a ``bench.call`` range the harness opens around the
call, which starts and ends with a ``torch.cuda.synchronize()``.

Besides, per range that the benchmark's own files open
(``record_function`` with a name starting ``bench.``), the device time of
the kernels launched inside it, and per autograd node name the device time
of the kernels launched while autograd evaluated such a node: a kernel
belongs to the ranges open on the thread that launched it when it was
launched (its runtime call, matched by correlation id). A reader asks for
either by name, never by a kernel's name.

The profiler's raw events are read directly (``kineto_results``): a
server epoch has about a million of them, and the profiler's own event
tree takes minutes to build.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

CALL_RANGE = "bench.call"
RANGE_PREFIX = "bench."
_BACKWARD = "autograd::engine::evaluate_function: "
_RUNTIME = ("cuda", "cu")  # runtime and driver calls that launch work


class _Ranges:
    """Named intervals of one thread, for 'which contain time t'."""

    def __init__(self):
        self.items: List[Tuple[int, int, str]] = []

    def add(self, s: int, t: int, name: str) -> None:
        self.items.append((s, t, name))

    def freeze(self) -> None:
        self.items.sort()
        self.starts = [s for s, _, _ in self.items]

    def containing(self, t: int):
        # Ranges on one thread nest or follow one another; scanning back
        # from the last start before t finds every one still open.
        i = bisect.bisect_right(self.starts, t)
        out = []
        for s, e, name in reversed(self.items[max(0, i - 64):i]):
            if e >= t:
                out.append(name)
        return out


class Trace:
    """The reduced trace of one call (times in seconds)."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        call = None
        device, cpu, launches = [], [], {}
        ranges: Dict[int, _Ranges] = defaultdict(_Ranges)
        for e in events:
            name, s, t = e.name(), e.start_ns(), e.end_ns()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append((s, t, name, e.correlation_id()))
                continue
            if name == CALL_RANGE:
                call = (s, t)
                continue
            tid = e.start_thread_id()
            if name.startswith(RANGE_PREFIX) or name.startswith(_BACKWARD):
                ranges[tid].add(s, t, name)
            if name.startswith(_RUNTIME):
                launches[e.correlation_id()] = (s, tid)
            if not e.is_user_annotation():
                cpu.append((s, t, name))
        if call is None:
            raise RuntimeError("the profiler recorded no call range")
        for r in ranges.values():
            r.freeze()
        t0, t1 = call
        spans: List[Tuple[int, int]] = []
        by_name: Dict[str, float] = defaultdict(float)
        self.range_s: Dict[str, float] = defaultdict(float)
        self.backward_s: Dict[str, float] = defaultdict(float)
        for s, t, name, corr in device:
            if s >= t1 or t <= t0:
                continue
            spans.append((max(s, t0), min(t, t1)))
            by_name[name] += (t - s) / 1e9
            launch = launches.get(corr)
            if launch is None or launch[1] not in ranges:
                continue
            for r in ranges[launch[1]].containing(launch[0]):
                if r.startswith(_BACKWARD):
                    self.backward_s[r[len(_BACKWARD):]] += (t - s) / 1e9
                else:
                    self.range_s[r] += (t - s) / 1e9
        spans.sort()
        merged: List[List[int]] = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.wall_s = (t1 - t0) / 1e9
        self.busy_s = sum(t - s for s, t in merged) / 1e9
        self.device_events = len(spans)
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        edges = [t0] + [x for m in merged for x in m] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        self.idle_gaps = [(_label(cpu, s, t), (t - s) / 1e9)
                          for s, t in gaps[:10]]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.wall_s


def _label(cpu, s: int, t: int) -> str:
    """What the host ran across the gap: the innermost CPU op covering its
    middle, else the op overlapping it the longest."""
    mid = (s + t) // 2
    cover = [(b - a, n) for a, b, n in cpu if a <= mid <= b]
    if cover:
        return "host: " + min(cover)[1]
    overlap = [(min(b, t) - max(a, s), n) for a, b, n in cpu
               if a < t and b > s]
    return "host: " + max(overlap)[1] if overlap else "host: idle"


def profile_call(fn: Callable[[], None]) -> Trace:
    """``fn()`` under the profiler, inside the ``bench.call`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(CALL_RANGE):
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    return Trace(prof.profiler.kineto_results.events())
