"""phase_wall_s: the window's seconds over the phase calls it completed
(whole calls, each between two ``torch.cuda.synchronize()``), what a
round's phase takes by the host's clock. The eager phase is bound by the
host's dispatch, so it varies from run to run with the host; the
end-to-end ``call_device_s`` is its steady counterpart. Layer: round."""

UNIT = "s"


def read(records):
    calls = records.get("calls")
    if not calls or not records.get("window_s"):
        return None
    return records["window_s"] / len(calls)
