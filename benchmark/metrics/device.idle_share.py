"""Percent of the marked plans' wall time in which no operation ran on
the device (1 - the union of device operations over the block's range)."""
from benchmark.tracing import union_seconds

SOURCE = "device_trace"


def read(run):
    b = run.marked
    if b is None or not b.device:
        return None
    window = b.window.end - b.window.start
    return 100.0 * (1.0 - union_seconds(b.device) / window)
