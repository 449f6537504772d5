"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
after ``reset_peak_memory_stats()`` at its start, in GiB. Layer: device."""

UNIT = "GiB"


def read(records):
    peak = records.get("window_peak_bytes")
    return None if not peak else peak / 2 ** 30
