"""ssm_host_share: the host seconds the phase's thread spent in the
program's ``creamfl.mamba.*`` spans (the mixers' projections, conv, scan
and gated norm: ``models/granite_h.py``) during the profiled call, over
the call's wall seconds, in %. Layer: model step (the Mamba mixers)."""

UNIT = "%"

_SPANS = ("creamfl.mamba.proj", "creamfl.mamba.conv", "creamfl.mamba.scan",
          "creamfl.mamba.norm")


def read(records):
    trace = records.get("trace")
    program = records.get("program")
    if trace is None or not program or not trace.wall_s:
        return None
    host = sum(program["seconds"].get(s, 0.0) for s in _SPANS)
    return 100.0 * host / trace.wall_s if host else None
