"""The trace reduction on a hand-made event list: the device's busy time
is the union of its intervals over the call's range, a kernel counts
toward the ``bench.*`` range or the autograd node open on the thread that
launched it, and the idle gaps are named by what the host ran."""

import pytest
import torch

from benchlib.trace import Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, s, t, dev=CPU, corr=0, tid=1, ann=False):
        self._v = (name, s, t, dev, corr, tid, ann)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_union_ranges_and_gaps():
    back = "autograd::engine::evaluate_function: FusedGalleryCEBackward"
    events = [
        Ev("bench.call", 0, 1000, ann=True),
        Ev("aten::mm", 0, 90),
        Ev("cudaLaunchKernel", 10, 12, corr=7),
        Ev("bench.k3", 100, 200, ann=True),
        Ev("cudaLaunchKernel", 110, 112, corr=8),
        Ev("aten::sleep_on_host", 300, 700),
        Ev(back, 700, 800, tid=2),
        Ev("cuLaunchKernel", 710, 712, corr=9, tid=2),
        # kernels: two overlapping, one in the k3 range, one backward
        Ev("gemm", 20, 80, CUDA, corr=7),
        Ev("copy", 60, 100, CUDA, corr=0),
        Ev("k3_fwd", 120, 160, CUDA, corr=8),
        Ev("k3_bwd", 720, 760, CUDA, corr=9),
        Ev("after_the_call", 1100, 1200, CUDA, corr=0),
    ]
    tr = Trace(events)
    assert tr.wall_s == pytest.approx(1000e-9)
    # union: [20, 100] + [120, 160] + [720, 760] = 80 + 40 + 40
    assert tr.busy_s == pytest.approx(160e-9)
    assert tr.idle_share == pytest.approx(1 - 160 / 1000)
    assert tr.range_s["bench.k3"] == pytest.approx(40e-9)
    assert tr.backward_s["FusedGalleryCEBackward"] == pytest.approx(40e-9)
    assert tr.device_events == 4
    longest = tr.idle_gaps[0]
    assert longest[0] == "host: aten::sleep_on_host"
    assert longest[1] == pytest.approx(560e-9)
    assert dict(tr.device_ops)["gemm"] == pytest.approx(60e-9)
