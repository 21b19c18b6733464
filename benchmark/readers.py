"""What the per-layer metrics' readers share: a layer's host time per
iteration from the synchronised spans, its device time from the kernels
that ran inside its profiler ranges, and its counted work."""
from __future__ import annotations

from typing import Optional

from . import counts, tracing


def ms_per_iteration(run, layer: str) -> Optional[float]:
    """Host ms a window iteration spends in ``layer``'s synchronised
    spans (the window's unprofiled part), or None where it has none."""
    spans = [s for s in run.spans
             if s.layer == layer and s.top == "iteration" and s.block == "w"]
    if not spans or not run.iterations:
        return None
    return sum(s.t1 - s.t0 for s in spans) * 1e3 / run.iterations


def device_seconds(block, layer: str) -> float:
    """Device seconds of the operations launched inside ``layer``'s
    ranges of a synchronised block (each range waits for its work, so
    nothing it launched runs outside it)."""
    ranges = [r for r in block.ranges if r.name == f"bench/{layer}"]
    return sum(d.end - d.start for d in block.device
               if any(r.start <= tracing.host_time(d) < r.end
                      for r in ranges))


def layer_shapes(run, layer: str):
    """The recorded shapes of ``layer``'s calls inside iterations of the
    synchronised profiled block."""
    return [s.shape for s in run.spans
            if s.layer == layer and s.top == "iteration" and s.block == "b"
            and s.shape is not None]


def roofline(run, layer: str, work) -> Optional[float]:
    """Percent of the roofline of ``layer``'s counted work (``work(shape)
    -> (operations, bytes)`` for each call, or None for a call whose work
    is not this metric's) over its device time in the synchronised
    profiled block; None where either is missing."""
    if run.synced is None:
        return None
    flops = nbytes = 0
    for shape in layer_shapes(run, layer):
        w = work(shape)
        if w is None:
            return None
        flops, nbytes = flops + w[0], nbytes + w[1]
    seconds = device_seconds(run.synced, layer)
    if not flops or seconds <= 0:
        return None
    return counts.roofline_share(flops, nbytes, seconds)[0]
