"""loader_wait_share: the seconds the phase's thread waited in the
outermost loader's ``next()`` (``benchlib/loader_wait.py``) over the
window's seconds, in %. Layer: data."""

UNIT = "%"


def read(records):
    wait = records.get("loader_wait_s")
    if wait is None or not records.get("window_s"):
        return None
    return 100.0 * wait / records["window_s"]
