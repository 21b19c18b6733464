"""The program's own spans on the device trace's clock, for the readers of
the ``program_span`` metrics that read inside the program.

The port's tracer (``irs_mpc_torch.utils.timing``) is on while a profiler
session records, so the traced run's profiled plans leave its records in
memory: each span's name, its host ``perf_counter_ns`` times, its parent,
its plan and its counts.  The trace gives its events in seconds on the
profiler's clock, whose base ``tracing.events`` drops, so the offset
between the two clocks is fitted: every program span of a call that the
benchmark also ranges (``cost``, ``lqr``, ``rollout``) is paired with the
``bench/<layer>`` range of the marked plans nearest to it, and the offset
is the median of their midpoints' differences.  A program without the
tracer leaves no records, and every reader then reports nothing.
"""
from __future__ import annotations

import bisect
import statistics
import sys
from typing import NamedTuple, Optional

from . import tracing

# Program spans whose call the benchmark ranges as the same layer, one
# range a span: the pairs that fit the clocks' offset.
PAIRED = ("cost", "lqr", "rollout")
# A pair whose midpoints lie further apart than this is not one call.
PAIR_S = 1e-3


class ProgramSpan(NamedTuple):
    name: str
    start: float          # seconds on the trace's clock
    end: float
    top: Optional[str]    # "plan_init" or "iteration": where it ran
    counts: dict


class Marked(NamedTuple):
    """The program's spans in the marked plans, and the device's busy
    time there: the union of its operations as sorted disjoint intervals,
    their starts and their ends."""
    spans: list
    busy_starts: list
    busy_ends: list
    iterations: int


def records():
    """The tracer's records, or None where the program has no tracer."""
    timing = sys.modules.get("irs_mpc_torch.utils.timing")
    read = getattr(timing, "records", None)
    return None if read is None else read()


def _tops(recs):
    """The outermost enclosing span's name of each record (None at the
    top)."""
    out = []
    for r in recs:
        p = r.parent
        if p < 0:
            out.append(None)
        else:
            top = out[p]
            out.append(recs[p].name if top is None else top)
    return out


def _nearest(ranges, starts, mid):
    """The range of ``ranges`` (sorted by start; ``starts`` their starts)
    whose midpoint is nearest to ``mid``."""
    i = bisect.bisect_right(starts, mid)
    near = ranges[max(i - 2, 0):i + 1]
    if not near:
        return None
    return min(near, key=lambda r: abs(0.5 * (r.start + r.end) - mid))


def offset(recs, ranges) -> Optional[float]:
    """Seconds to add to a record's ``perf_counter`` seconds to put it on
    the trace's clock, fitted on the pairs of ``PAIRED`` spans and
    ``bench/`` ranges (``ranges``), or None where nothing pairs."""
    by_layer = {}
    for r in sorted(ranges, key=lambda r: r.start):
        by_layer.setdefault(r.name[len("bench/"):], []).append(r)
    plans = by_layer.get("plan_init")
    inits = [r for r in recs if r.name == "plan_init" and r.t1 is not None]
    paired = [r for r in recs if r.name in PAIRED and r.t1 is not None
              and r.name in by_layer]
    if not plans or not inits or not paired:
        return None
    starts = {k: [r.start for r in v] for k, v in by_layer.items()}

    def deltas(coarse):
        out = []
        for r in paired:
            mid = (r.t0 + r.t1) * 0.5e-9
            b = _nearest(by_layer[r.name], starts[r.name], mid + coarse)
            if b is not None:
                d = 0.5 * (b.start + b.end) - mid
                if abs(d - coarse) < PAIR_S:
                    out.append(d)
        return out

    # A constructor ends where the benchmark's range around it ends; try
    # the first few against the first range, keep the best-paired.
    best = max((deltas(plans[0].end - r.t1 * 1e-9) for r in inits[:4]),
               key=len)
    return statistics.median(best) if best else None


def _busy(device):
    """The union of device operations: the starts and the ends of its
    sorted disjoint intervals."""
    starts, ends = [], []
    for d in sorted(device, key=lambda d: d.start):
        if ends and d.start <= ends[-1]:
            ends[-1] = max(ends[-1], d.end)
        else:
            starts.append(d.start)
            ends.append(d.end)
    return starts, ends


def marked(run) -> Optional[Marked]:
    """The program's closed spans whose start lies in the marked plans, on
    the trace's clock; None where the run was not traced, the program
    left no records, or no span pairs with a benchmark range."""
    b = run.marked
    recs = records()
    if b is None or not recs:
        return None
    off = offset(recs, b.ranges)
    if off is None:
        return None
    w = b.window
    spans = []
    for r, top in zip(recs, _tops(recs)):
        if r.t1 is None:
            continue
        start = r.t0 * 1e-9 + off
        if w.start <= start < w.end:
            spans.append(ProgramSpan(r.name, start, r.t1 * 1e-9 + off, top,
                                     dict(r.counts or {})))
    return Marked(spans, *_busy(b.device), b.iterations)


def busy_in(m: Marked, start: float, end: float) -> float:
    """Seconds in [start, end) in which the device was busy."""
    total = 0.0
    i = max(bisect.bisect_right(m.busy_starts, start) - 1, 0)
    while i < len(m.busy_starts) and m.busy_starts[i] < end:
        total += max(0.0, min(m.busy_ends[i], end)
                     - max(m.busy_starts[i], start))
        i += 1
    return total


def idle_ms_per_iteration(run, name: str) -> Optional[float]:
    """Device-idle ms inside the program's ``name`` spans (each span's time
    less the device's busy time in it), per iteration of the marked
    plans."""
    m = marked(run)
    if m is None or not m.iterations:
        return None
    spans = [s for s in m.spans if s.name == name]
    if not spans:
        return None
    idle = sum((s.end - s.start) - busy_in(m, s.start, s.end)
               for s in spans)
    return idle * 1e3 / m.iterations


def host_ms_per_iteration(run, name: str) -> Optional[float]:
    """Host ms inside the program's ``name`` spans within iterations, per
    iteration of the marked plans."""
    m = marked(run)
    if m is None or not m.iterations:
        return None
    spans = [s for s in m.spans if s.name == name and s.top == "iteration"]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) * 1e3 / m.iterations


def kernels_per_count(run, name: str, counter: str) -> Optional[float]:
    """Kernels launched inside the program's ``name`` spans over those
    spans' ``counter`` tallies, in the marked plans."""
    m = marked(run)
    if m is None:
        return None
    spans = sorted((s for s in m.spans if s.name == name),
                   key=lambda s: s.start)
    n = sum(s.counts.get(counter, 0) for s in spans)
    if not n:
        return None
    starts = [s.start for s in spans]
    launched = 0
    for d in run.marked.device:
        if not tracing.is_kernel(d.name):
            continue
        t = tracing.host_time(d)
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i].end:
            launched += 1
    return launched / n


def coverage(run) -> Optional[dict]:
    """Where the marked plans' idle time falls: seconds idle in all, those
    inside a program span below an ``iteration`` or a ``plan_init`` (a
    phase of the program), those in the two outside their phases (their
    self idle), and each span name's idle seconds."""
    m = marked(run)
    if m is None:
        return None
    w = run.marked.window
    idle = (w.end - w.start) - busy_in(m, w.start, w.end)

    def idle_in(spans):
        total, end = 0.0, float("-inf")
        for s in sorted(spans, key=lambda s: s.start):
            a, b = max(s.start, end), s.end
            if b > a:
                total += (b - a) - busy_in(m, a, b)
            end = max(end, b)
        return total

    phases = [s for s in m.spans if s.top is not None]
    out = {"idle_s": idle, "in_phases_s": idle_in(phases)}
    for top in ("iteration", "plan_init"):
        own = idle_in([s for s in m.spans if s.name == top])
        out[f"{top}_self_idle_s"] = own - idle_in(
            [s for s in phases if s.top == top])
    out["by_name_s"] = {n: idle_in([s for s in m.spans if s.name == n])
                        for n in sorted({s.name for s in m.spans})}
    return out
