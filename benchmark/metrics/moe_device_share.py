"""moe_device_share: the device seconds of the kernels launched inside the
``bench.moe`` ranges (the tower's MoE layers, forward and backward:
``phases/server_train_dsv2.py``'s ``traced_call``) over the profiled call's
busy seconds, in %. Layer: model step (the MoE layers)."""

UNIT = "%"


def read(records):
    trace = records.get("trace")
    if trace is None or not trace.busy_s:
        return None
    moe = trace.range_s.get("bench.moe", 0.0)
    return 100.0 * moe / trace.busy_s if moe else None
