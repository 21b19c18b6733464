"""One run of one cell: set-up, the measured window, the check of the
window's answers, and the traced run's readings.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json``, ``metrics/<metric>.py`` for each per-layer
metric, and ``reference/<config>.py``.  Adding a cell, a mix, a
configuration or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import check, problem, tracing, traffic

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# Whole plans the traced run profiles, after its first: two with the
# layers marked (busy share, idle gaps, kernels by name), two with the
# layers synchronised (the rooflines' device time by layer).
PROFILED_MARKED = 2
PROFILED_SYNCED = 2
# The warm-up plan's index: one the window never reaches.
WARM_PLAN = 2 ** 32


class UnknownName(ValueError):
    pass


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _file(folder: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise UnknownName(f"{name!r} is not a name")
    path = BENCH / folder / f"{name}{suffix}"
    if not path.is_file():
        raise UnknownName(f"no {folder[:-1] if folder.endswith('s') else folder} "
                          f"named {name!r} ({path.relative_to(ROOT)})")
    return path


def load_json(folder: str, name: str) -> dict:
    return json.loads(_file(folder, name, ".json").read_text())


def metric_reader(name: str):
    """The reader ``metrics/<name>.py``: ``SOURCE`` and ``read(run)``."""
    path = _file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    entry: dict
    config: dict
    mix: dict
    end_to_end: list      # the manifest's metrics this cell reports
    per_layer: list


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The workload ``name`` of the manifest, with its files."""
    bench = bench or manifest()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise UnknownName(f"no workload named {name!r} in BENCHMARK.json")
    w = entries[name]

    def mine(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]

    return Cell(name, w, load_json("configs", w["config"]),
                load_json("traffic", w["traffic"]),
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


class Setup(NamedTuple):
    program: object
    spans: tracing.Spans
    recorder: check.Recorder
    seconds: float


def set_up(c: Cell, seed: int, device, trace: bool,
           started: Optional[float] = None) -> Setup:
    """Import and build the program, install the recorder (and, traced,
    the spans), then warm the cell's shapes: one plan's constructor and
    its first two iterations.  Its seconds count from ``started`` (the
    process's start, where the caller has it) to the warm plan's end."""
    t0 = time.perf_counter() if started is None else started
    from . import program as prog
    p = prog.Program(c.config, c.mix, device)
    spans = tracing.Spans(device)
    if trace:
        spans.install(prog.LAYER_CALLS, p)
    recorder = check.Recorder(seed, c.mix["checked_iterations"],
                              check.resolved(c.config, c.mix),
                              first=c.mix["solver"] != "cem")
    recorder.install(prog.IrsMpc, prog.CrossEntropyMethod, prog.port_irs)
    warm = traffic.plan(c.mix, c.config["nq"], seed, WARM_PLAN)
    solver = p.solver(problem.make(c.config, c.mix, warm), warm.solver_seed)
    solver.iterate(2, verbose=False)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return Setup(p, spans, recorder, time.perf_counter() - t0)


class Window(NamedTuple):
    seconds: float
    plans: int
    iterations: int
    failed: int
    launches: dict        # each kernel's launches in the window
    iter_s: list
    profile: Optional[tuple]      # (marked Block, synced Block) traced


def _phase(index: int):
    """(profiled block, span mode, span block) of plan ``index`` of a
    traced window."""
    if index < PROFILED_MARKED:
        return "marked", "mark", "a"
    if index < PROFILED_MARKED + PROFILED_SYNCED:
        return "synced", "sync", "b"
    return None, "sync", "w"


def run_window(c: Cell, s: Setup, seed: int, seconds: float,
               trace: bool) -> Window:
    """Plans back to back for ``seconds``: each a new solver on the
    plan's problem (its constructor included), then the mix's iterations,
    one ``iterate(1)`` at a time.  The window closes at the end of the
    first plan that ends after ``seconds``, so it holds whole plans only
    (a plan's constructor alone is up to 0.9 of its time).  Traced, the
    first plans run under one profiler session (marked, then
    synchronised) and the rest with the layers synchronised."""
    iters = c.mix["iterations_per_plan"]
    spans, rec = s.spans, s.recorder
    prof = finished = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    profiled: dict = {}                # block name -> iterations
    iter_s, failed, index = [], 0, 0
    rec.active = True
    before = s.program.launches()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t1 = t_start
    while t1 < deadline:
        block = None
        if trace:
            block, spans.mode, spans.block = _phase(index)
            if block is None and prof is not None:
                prof.__exit__(None, None, None)
                finished, prof = prof, None
        pl = traffic.plan(c.mix, c.config["nq"], seed, index)
        rec.plan = index
        with (torch.profiler.record_function(f"bench/{block}") if block
              else contextlib.nullcontext()):
            with spans.span("plan_init", top=True):
                solver = s.program.solver(problem.make(c.config, c.mix, pl),
                                          pl.solver_seed)
            rec.starts[index] = (pl, solver.x_trj, solver.cost)
            for _ in range(iters):
                t0 = time.perf_counter()
                with spans.span("iteration", top=True):
                    solver.iterate(1, verbose=False)
                t1 = time.perf_counter()
                iter_s.append(t1 - t0)
        if block:
            profiled[block] = profiled.get(block, 0) + iters
        failed += not np.isfinite(solver.cost)
        index += 1
    t_end = time.perf_counter()
    launched = {k: v - before[k] for k, v in s.program.launches().items()}
    rec.active = False
    spans.mode = "off"
    blocks = None
    if trace:
        if prof is not None:
            prof.__exit__(None, None, None)
            finished = prof
        device, ranges = tracing.events(finished)
        blocks = tuple(tracing.split_block(device, ranges, b,
                                           profiled.get(b, 0))
                       for b in ("marked", "synced"))
    return Window(t_end - t_start, index, len(iter_s), failed, launched,
                  iter_s, blocks)


class TraceRun(NamedTuple):
    """What a per-layer metric's reader gets."""
    config: dict
    mix: dict
    spans: list           # tracing.Span of the synchronised parts
    marked: Optional[tracing.Block]
    synced: Optional[tracing.Block]
    iterations: int       # iterations of the window's last part ("w")


def end_to_end(c: Cell, s: Setup, w: Window) -> dict:
    """The cell's end-to-end metrics.  A metric named ``<base>.<part>``
    reads ``<base>`` in the cells it lists, under a bound of its own
    (``plan_ms.cem``)."""
    values = {
        "plan_ms": w.seconds * 1e3 / w.plans,
        "setup_s": s.seconds,
    }
    return {m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]}
            for m in c.end_to_end}


def per_layer(c: Cell, s: Setup, w: Window) -> dict:
    marked, synced = w.profile
    run = TraceRun(c.config, c.mix, s.spans.records, marked, synced,
                   sum(1 for sp in s.spans.records
                       if sp.layer == "iteration" and sp.block == "w"))
    out = {}
    for m in c.per_layer:
        v = metric_reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(block: Optional[tracing.Block]) -> Optional[dict]:
    """The ten device operations that took most time in the marked
    plans, and the ten longest idle gaps by the benchmark range the host
    was in (the innermost one at the gap's middle)."""
    if block is None or not block.device:
        return None
    by_op: dict = {}
    for d in block.device:
        by_op[d.name] = by_op.get(d.name, 0.0) + (d.end - d.start)
    by_gap: dict = {}
    for g0, g1 in tracing.busy_gaps(block.device, block.window):
        mid = 0.5 * (g0 + g1)
        inner = [r for r in block.ranges if r.start <= mid < r.end]
        name = (min(inner, key=lambda r: r.end - r.start).name
                if inner else "bench/harness")
        by_gap[name] = by_gap.get(name, 0.0) + (g1 - g0)
    top = lambda d: [[k[:200], v] for k, v in sorted(   # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def device_line(device, block: Optional[tracing.Block], trace: bool):
    from .card import card
    d = card(device)
    if trace and block is not None:
        d["busy_s"] = tracing.union_seconds(block.device)
        d["window_s"] = block.window.end - block.window.start
    return d


def run(c: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        log=sys.stderr, started: Optional[float] = None) -> dict:
    """One run of the cell ``c``; returns the result line's object.
    Prints the window's counts and each number compared beside its limit
    on ``log``."""
    limits = check.load_limits(c.name)
    s = set_up(c, seed, device, trace, started)
    w = run_window(c, s, seed, seconds, trace)
    if torch.device(device).type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    print(f"window {w.seconds:.6f} s: {w.plans} plans, {w.iterations} "
          f"iterations "
          f"(median {statistics.median(w.iter_s) * 1e3:.4f} ms); kernel "
          f"launches an iteration: " + ", ".join(
              f"{k} {v / w.iterations:.4f}" for k, v in w.launches.items()),
          file=log)
    metrics = per_layer(c, s, w) if trace else end_to_end(c, s, w)
    marked = w.profile[0] if trace else None
    dev = device_line(device, marked, trace)
    dev["memory_peak_bytes"] = int(peak)
    # The window runs at the process's own thread count, as the port's
    # drivers do; the float64 reference of the check, small products on
    # the host, runs on one thread.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        values = check.numbers(c.config, c.mix, s.recorder, device)
    finally:
        torch.set_num_threads(threads)
    ok, table = check.judge(values, limits)
    for k, v in table.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=log)
    result = {"correct": bool(ok), "attempted": w.plans,
              "failed": w.failed, "metrics": metrics, "device": dev}
    if trace:
        b = breakdown(marked)
        if b is not None:
            result["breakdown"] = b
    result["check"] = table
    return result
