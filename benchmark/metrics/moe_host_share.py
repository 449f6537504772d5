"""moe_host_share: the host seconds the phase's thread spent in the
program's ``creamfl.moe.*`` spans (routing, held experts, combination:
``models/deepseek_v2.py``) during the profiled call, over the call's wall
seconds, in %. Layer: model step (the MoE layers)."""

UNIT = "%"

_SPANS = ("creamfl.moe.route", "creamfl.moe.experts", "creamfl.moe.combine")


def read(records):
    trace = records.get("trace")
    program = records.get("program")
    if trace is None or not program or not trace.wall_s:
        return None
    host = sum(program["seconds"].get(s, 0.0) for s in _SPANS)
    return 100.0 * host / trace.wall_s if host else None
