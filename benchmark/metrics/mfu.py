"""mfu: the model operations of the window's steps (the cell's
configuration's ``<config>_flops.py`` a sample, times the rows of the
steps the phase counted) over the window's seconds and the card's dense
bf16 peak, in %. The window's calls run outside the profiler. Layer:
model step."""

from benchlib import peaks

UNIT = "%"


def read(records):
    flops = records.get("flops")
    if not flops or not records.get("window_s"):
        return None
    return 100.0 * flops / records["window_s"] / peaks.BF16_FLOPS
