"""Spans around the calls into each layer, from the benchmark's own files,
and what the traced run reads from the profiler.

A span has three modes.  "off": the call runs bare (the untraced run, and
the warm-up).  "mark": the call runs inside a ``torch.profiler`` range
named ``bench/<layer>`` and nothing waits, so the device's busy share and
its idle gaps are the program's own.  "sync": the device is synchronised
before and after the call, its host time is recorded with the shapes of
its arguments, and the profiler range is open too, so every kernel the
call launched runs inside the range: the roofline readers attribute
device time to a layer by that containment.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    layer: str
    t0: float             # host perf_counter seconds
    t1: float
    top: Optional[str]    # "plan_init" or "iteration": where it ran
    block: str            # the part of the window: "b" (profiled) or "w"
    shape: Optional[dict]


def _shape(layer, args, kwargs):
    """The shapes of a layer call that its work is counted from."""
    if layer == "estimation" and len(args) >= 7:
        mode, u_trj, cfg = args[1], args[3], args[6]
        return dict(mode=mode, T=int(u_trj.shape[0]), S=cfg.num_samples)
    if layer == "lqr":
        prob, bounds = args[0], args[1]
        return dict(T=int(prob.B.shape[0]), n=int(prob.B.shape[1]),
                    m=int(prob.B.shape[2]), sweeps=int(kwargs["iters"]),
                    box_kinds=sum(b is not None for b in bounds))
    if layer == "rollout":
        K, z_ref_w, u_ref, rel_lb = args[2], args[4], args[5], args[8]
        A, T, m = u_ref.shape
        return dict(A=int(A), T=int(T), m=int(m), nz=int(K.shape[-1]),
                    aug=z_ref_w is not None, rel=rel_lb is not None)
    return None


class Spans:
    """The spans of one run; ``mode`` and ``block`` are set by the
    harness as the window goes on."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.mode = "off"
        self.block = "w"
        self.records: list[Span] = []
        self._top: Optional[str] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, layer: str, fn):
        """``fn`` with a span of ``layer`` around each call."""
        def run(*args, **kwargs):
            if self.mode == "off":
                return fn(*args, **kwargs)
            with self.span(layer, _shape(layer, args, kwargs)):
                return fn(*args, **kwargs)
        return run

    @contextmanager
    def span(self, layer: str, shape=None, top: bool = False):
        """A span of ``layer``; ``top`` marks a plan's constructor or an
        iteration, which the layer spans inside it name as theirs."""
        if self.mode == "off":
            yield
            return
        name = f"bench/{layer}"
        if self.mode == "mark":
            with torch.profiler.record_function(name):
                yield
            return
        outer = self._top
        if top:
            self._top = layer
        self._sync()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
                self._sync()
        finally:
            self._top = outer
        self.records.append(Span(layer, t0, time.perf_counter(),
                                 None if top else self._top, self.block,
                                 shape))

    def install(self, calls, program):
        """Wrap each (owner, attribute, layer) of ``calls``, and the
        program's system's whole-chain rollout as layer "rollout"."""
        for owner, attr, layer in calls:
            setattr(owner, attr, self.wrap(layer, getattr(owner, attr)))
        sys = program.system
        if sys.ls_rollout_fn is not None:
            program.system = dataclasses.replace(
                sys, ls_rollout_fn=self.wrap("rollout", sys.ls_rollout_fn))


# ---------------------------------------------------------------------------
# The profiler's events
# ---------------------------------------------------------------------------

class Interval(NamedTuple):
    name: str
    start: float          # seconds on the profiler's clock
    end: float
    # A device operation's launch on the host's clock (the API call with
    # its correlation id), where the trace has it.
    launched: Optional[float] = None


class Block(NamedTuple):
    """One profiled part of the window: its own range, the device
    operations in it, the benchmark's ranges in it, and the iterations it
    holds."""
    window: Interval
    device: list          # [Interval] of every device operation
    ranges: list          # [Interval] of bench/<layer> ranges
    iterations: int


def is_kernel(name: str) -> bool:
    """A device kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def events(prof):
    """(device operations, bench/ ranges) of a finished profiler session,
    as Intervals in seconds on the trace's clock.  Read from its exported
    Chrome trace (written to a temporary directory and deleted): a
    session of a few plans holds ~10^5 events, which the trace's JSON
    gives in seconds and ``prof.events()`` in minutes.  Each device
    operation carries the host time of the call that launched it, matched
    by correlation id: a range holds the launches made inside it on the
    host's own clock, whatever the device's clock is offset by."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    launches, device, ranges = {}, [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        start = float(ev["ts"]) * 1e-6
        end = start + float(ev.get("dur", 0)) * 1e-6
        corr = ev.get("args", {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            device.append((Interval(name, start, end), corr))
        elif cat in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = start
        elif cat == "user_annotation" and name.startswith("bench/"):
            ranges.append(Interval(name, start, end))
    return [iv._replace(launched=launches.get(corr)) for iv, corr in device], \
        ranges


def host_time(iv: Interval) -> float:
    """When a device operation was launched, or where the trace lacks it,
    when it started."""
    return iv.start if iv.launched is None else iv.launched


def split_block(device, ranges, name: str, iterations: int) -> Optional[Block]:
    """The part of the session in the plans ranged ``bench/<name>`` (one
    range a plan, back to back): from the first's start to the last's
    end."""
    plans = [r for r in ranges if r.name == f"bench/{name}"]
    if not plans:
        return None
    w = Interval(name, min(r.start for r in plans), max(r.end for r in plans))

    return Block(w, [d for d in device if w.start <= host_time(d) < w.end],
                 [r for r in ranges
                  if w.start <= r.start < w.end and r not in plans],
                 iterations)


def union_seconds(intervals) -> float:
    """Seconds covered by the union of intervals."""
    total, end = 0.0, float("-inf")
    for iv in sorted(intervals, key=lambda i: i.start):
        if iv.end > end:
            total += iv.end - max(iv.start, end)
            end = iv.end
    return total


def busy_gaps(device, window: Interval):
    """The idle gaps (start, end) between device operations in
    ``window``."""
    gaps, end = [], window.start
    for iv in sorted(device, key=lambda i: i.start):
        if iv.start > end:
            gaps.append((end, iv.start))
        end = max(end, iv.end)
    if window.end > end:
        gaps.append((end, window.end))
    return gaps
