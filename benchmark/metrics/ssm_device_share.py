"""ssm_device_share: the device seconds of the kernels launched inside the
``bench.ssm`` ranges (the tower's Mamba mixers, forward and backward:
``phases/server_train_granite4h.py``'s ``traced_call``) over the profiled
call's busy seconds, in %. Layer: model step (the Mamba mixers)."""

UNIT = "%"


def read(records):
    trace = records.get("trace")
    if trace is None or not trace.busy_s:
        return None
    ssm = trace.range_s.get("bench.ssm", 0.0)
    return 100.0 * ssm / trace.busy_s if ssm else None
