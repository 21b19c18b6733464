"""The program's tracer and the profiler trace.

The port of ``irs_mpc_tpu/utils/timing.py``, with one tracer in place of
its phase timer.  ``span(name)`` and ``count(name, k)`` mark the solvers'
phases where they run (``plan_init``, ``iteration``, ``estimation``,
``lqr``, ``rollout``, ``cost``, ``chain`` with its ``knots``, CEM's
``sample`` and ``refit``, and ``sync`` around every call that makes the
host wait for the card).  A ``chain`` that runs as one kernel launch
also counts ``chain_kernel``; an ``estimation`` counts ``est_graph`` for
each replay of its fused sweep's CUDA graph and ``est_capture`` for each
capture of one.  The iRS constructor's dynamics probe runs in the span
``probe`` inside ``plan_init``, which counts ``probe_reused`` where the
system had passed it on the device before.  Off by default, a span costs
one check.  Switch it on with ``tracing()`` or by profiling
(``profile_trace``: every span is then also a range ``irs/<name>`` in the
Chrome trace), then read
``records()``, ``counted()`` (the counts of a span's name, summed) or
``report()`` (host milliseconds by name).  Spans never synchronise: a
span's time is the host's.  ``block_until_ready`` waits
for the CUDA devices that hold the given tensors, the counterpart of
``jax.block_until_ready``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import subprocess
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler


def _cuda_devices(obj, found):
    """The CUDA devices of the tensors in ``obj`` (nested tuples, lists,
    dicts and dataclasses)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)
    return found


def block_until_ready(obj):
    """Wait until every CUDA device that holds a tensor of ``obj`` has
    finished the work queued on it; returns ``obj``."""
    for device in _cuda_devices(obj, set()):
        torch.cuda.synchronize(device)
    return obj


# ---------------------------------------------------------------------------
# The tracer: spans and counters inside the program
# ---------------------------------------------------------------------------

# Records the buffer holds; spans opened once it is full are counted in
# ``Tracer.dropped`` and not kept.
CAPACITY = 1 << 20


class Span:
    """One span's record: its ``name``, ``t0`` and ``t1`` (host
    ``time.perf_counter_ns()``; ``t1`` is None while the span is open), the
    index of its ``parent`` in the buffer (-1 at the top), the ``plan`` (the
    solver) it ran for (-1 outside any solver) and its ``counts`` (a dict,
    or None where nothing was counted)."""
    __slots__ = ("name", "t0", "t1", "parent", "plan", "counts")

    def __init__(self, name, t0, parent, plan):
        self.name, self.t0, self.t1 = name, t0, None
        self.parent, self.plan, self.counts = parent, plan, None

    def __repr__(self):
        return (f"Span({self.name!r}, t0={self.t0}, t1={self.t1}, "
                f"parent={self.parent}, plan={self.plan}, "
                f"counts={self.counts})")


class _Open:
    """The context of one recorded span."""
    __slots__ = ("tracer", "name", "plan", "record", "range")

    def __init__(self, tracer, name, plan):
        self.tracer, self.name, self.plan = tracer, name, plan
        self.record = self.range = None

    def __enter__(self):
        t0 = time.perf_counter_ns()
        if profiling():
            self.range = torch.profiler.record_function(f"irs/{self.name}")
            self.range.__enter__()
        tr = self.tracer
        if len(tr._records) >= tr.capacity:
            tr.dropped += 1
            return None
        parent = tr._stack[-1] if tr._stack else -1
        plan = self.plan
        if plan is None:
            plan = tr._records[parent].plan if parent >= 0 else -1
        self.record = Span(self.name, t0, parent, plan)
        tr._stack.append(len(tr._records))
        tr._records.append(self.record)
        return self.record

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.record is not None:
            self.record.t1 = time.perf_counter_ns()
            tr = self.tracer
            if tr._stack and tr._records[tr._stack[-1]] is self.record:
                tr._stack.pop()
        return False


class Tracer:
    """Spans and counters of one process, kept in memory.

    Off (the default) a span site costs one check and records nothing.  It
    is on while ``enabled`` is set (``tracing()``) or while a
    ``torch.profiler`` session records (``profile_trace``); then every span
    keeps one ``Span`` in a buffer of ``capacity`` records, and under the
    profiler also opens the range ``irs/<name>``, so that the exported
    trace shows the program's phases on the device trace's clock.  Nothing
    here waits for the device: a span's time is the host's, and the device
    work it queued may run after it closes."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self.dropped = 0
        self._records: list = []
        self._stack: list = []          # indices of the open spans
        self._plans = itertools.count()

    def span(self, name: str, plan: Optional[int] = None):
        """A context that records the span ``name`` when the tracer is on;
        it yields the ``Span`` (None when off or full).  ``plan`` gives the
        solver's id; without it the span takes its parent's."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, plan)

    def count(self, name: str, k: int = 1):
        """Add ``k`` to the tally ``name`` of the innermost open span."""
        if self._stack:
            rec = self._records[self._stack[-1]]
            if rec.counts is None:
                rec.counts = {}
            rec.counts[name] = rec.counts.get(name, 0) + k

    def new_plan(self) -> int:
        """A new solver's id (a process-wide counter)."""
        return next(self._plans)

    def records(self) -> list:
        """The buffer: every ``Span`` recorded since the last ``reset``,
        in the order they opened."""
        return self._records

    def reset(self):
        """Empty the buffer (spans still open are no longer recorded)."""
        self._records = []
        self._stack = []
        self.dropped = 0


_OFF = contextlib.nullcontext()
TRACER = Tracer()
span = TRACER.span
count = TRACER.count
new_plan = TRACER.new_plan
records = TRACER.records
reset = TRACER.reset


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return _profiler._is_profiler_enabled


def spanned(name: str):
    """Decorator: every call of the function runs in the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def tracing(on: bool = True):
    """Switch the tracer on (or off) for a block, then back as it was."""
    was = TRACER.enabled
    TRACER.enabled = on
    try:
        yield
    finally:
        TRACER.enabled = was


def counted(name: str) -> Counter:
    """The counts of the buffer's spans called ``name``, summed."""
    total: Counter = Counter()
    for s in records():
        if s.name == name:
            total.update(s.counts or {})
    return total


def report() -> str:
    """Host milliseconds by span name of the buffer's closed spans: total,
    calls and mean, the largest total first."""
    totals: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for s in records():
        if s.t1 is not None:
            totals[s.name] += (s.t1 - s.t0) * 1e-6
            calls[s.name] += 1
    lines = []
    for name in sorted(totals, key=totals.get, reverse=True):
        t, c = totals[name], calls[name]
        lines.append(f"{name:24s} total {t:10.2f} ms   "
                     f"calls {c:5d}   mean {t / c:8.3f} ms")
    return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(logdir=None):
    """One ``torch.profiler`` session of the host and, where there is one,
    the card around a block; yields the profiler and writes its Chrome
    trace to ``logdir/trace.json`` when the block ends (by default
    ``irs_mpc_torch_trace`` in the temporary directory).  The tracer is
    on while the session records: the trace holds each span as a range
    ``irs/<name>``, and ``records()`` and ``report()`` read them after.

    Open one session a process, early: on the H100 the profiler lost
    device events late in a process that had traced many sessions before
    (``PERF.md`` §6), so a later session may show no device time at
    all."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir if logdir is not None else os.path.join(
        tempfile.gettempdir(), "irs_mpc_torch_trace"))
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
