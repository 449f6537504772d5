"""moe_experts_roofline: the held experts' model operations in the profiled
call over the device seconds of the kernels launched inside the
``bench.moe.experts`` ranges (their forward and backward), against the
card's dense bf16 peak, in %: the grouped products' share of their
roofline, whatever implements them. The operations: the pairs the held
experts computed (the program's device tally ``moe.held_pairs``, read when
the recording closes) x 3 products x 2 x hidden x expert width, x 3 for
the forward and the backward. Layer: model step (the MoE layers)."""

from benchlib import peaks

UNIT = "%"


def read(records):
    trace = records.get("trace")
    program = records.get("program")
    if trace is None or not program:
        return None
    pairs = program["counters"].get("moe.held_pairs")
    seconds = trace.range_s.get("bench.moe.experts", 0.0)
    width = records.get("expert_shape")
    if not pairs or not seconds or not width:
        return None
    hidden, inner = width
    flops = pairs * 3 * 2 * hidden * inner * 3
    return 100.0 * flops / seconds / peaks.BF16_FLOPS
