"""Seconds the phase's thread waits for loader batches.

A copy of ``chip_smoke.py:_HostLoaderTime``: each ``next`` of the
outermost loader the main thread iterates (``ArrayLoader``,
``PrefetchLoader``, ``GrainLoader``, ``DeviceImageBatches`` or
``DeviceImages``) is timed, so rendering and stacking on that thread, a
prefetch queue's wait, the enqueueing of on-device synthesis and the
decoding of real images; a loader nested in another is not counted twice.
What ``ArrayLoader`` spends on prefetch threads, which overlaps the phase,
is kept apart in ``thread_seconds``. The patch is on the loader classes
while the context is open and is taken off at its exit.
"""

from __future__ import annotations

import threading
import time


class LoaderWait:
    def __init__(self):
        from creamfl_tpu_torch.data import (device_images, device_synth,
                                           grain_loaders, loaders)

        self.producer = loaders.ArrayLoader
        self.orig = {cls: cls.__iter__ for cls in (
            loaders.ArrayLoader, loaders.PrefetchLoader,
            grain_loaders.GrainLoader, device_synth.DeviceImageBatches,
            device_images.DeviceImages)}
        self.seconds = self.thread_seconds = 0.0
        self.depth = 0
        self.lock = threading.Lock()

    def _timed(self, orig, producer: bool):
        timer = self

        def timed(loader):
            it = orig(loader)
            on_main = threading.current_thread() is threading.main_thread()
            while True:
                outer = on_main and timer.depth == 0
                t0 = time.perf_counter()
                if on_main:
                    timer.depth += 1
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    dt = time.perf_counter() - t0
                    if on_main:
                        timer.depth -= 1
                        if outer:
                            timer.seconds += dt
                    elif producer:
                        with timer.lock:
                            timer.thread_seconds += dt
                yield batch

        return timed

    def __enter__(self):
        for cls, orig in self.orig.items():
            cls.__iter__ = self._timed(orig, cls is self.producer)
        return self

    def __exit__(self, *exc):
        for cls, orig in self.orig.items():
            cls.__iter__ = orig
