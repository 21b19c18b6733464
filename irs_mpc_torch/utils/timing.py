"""Labelled phase timers and a profiler trace.

The port of ``irs_mpc_tpu/utils/timing.py``: the same ``PhaseTimer`` (host
milliseconds a phase, with its call count) and ``profile_trace``, a
``torch.profiler`` session of the host and the card written as a Chrome
trace.  ``block_on`` waits for the CUDA devices that hold the given
tensors, the counterpart of ``jax.block_until_ready``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch


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


class PhaseTimer:
    """Accumulates host wall time per labelled phase.

    Usage::
        timer = PhaseTimer()
        with timer.phase("estimate", block_on=solver.x_trj):
            ...
        print(timer.report())

    With ``block_on``, a phase ends only when the devices holding those
    tensors are done, so that it covers the device work it queued."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} total {t * 1e3:10.2f} ms   "
                         f"calls {c:5d}   mean {t / c * 1e3:8.3f} ms")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def profile_trace(logdir=None):
    """One ``torch.profiler`` session of the host and, where there is one,
    the card around a block; yields the profiler and writes its Chrome
    trace to ``logdir/trace.json`` when the block ends (by default
    ``irs_mpc_torch_trace`` in the temporary directory).

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
