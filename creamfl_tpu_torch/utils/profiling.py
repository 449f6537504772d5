"""Per-phase wall-clock timers.

``StepTimer`` collects named phase times and reports them. On a CUDA
device (the default) each phase starts and ends with
``torch.cuda.synchronize()``, so asynchronous kernel launches are charged
to the phase that made them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

from creamfl_tpu_torch.utils.device import resolve_device


class StepTimer:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        """{phase_s: total seconds, phase_n: count}; clears the totals."""
        summary = {}
        for k, v in self.totals.items():
            summary[f"{k}_s"] = round(v, 3)
            summary[f"{k}_n"] = self.counts[k]
        self.totals.clear()
        self.counts.clear()
        return summary
