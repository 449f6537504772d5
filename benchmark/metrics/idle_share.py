"""idle_share: one minus the union of the device's event intervals over
the wall time of one steady phase call under the profiler, in %
(``benchlib/trace.py``). Layer: device."""

UNIT = "%"


def read(records):
    trace = records.get("trace")
    if trace is None or trace.device_events == 0:
        return None
    return 100.0 * trace.idle_share
