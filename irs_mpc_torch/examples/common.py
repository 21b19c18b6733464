"""What the example drivers share: running a solver with each iteration
timed, and writing its cost curve.

The port's counterpart of ``examples/common.py``.  The committed curves of
the JAX package, ``examples/analysis/*.csv``, are read here and never
written: the port writes its curves to ``irs_mpc_torch/_build/curves/`` (a
git-ignored directory) or wherever a caller points ``out_dir``.
"""
from __future__ import annotations

import statistics
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

# The JAX package's committed cost curves: read-only for the port.
ANALYSIS_DIR = Path(__file__).resolve().parents[2] / "examples" / "analysis"
OUT_DIR = Path(__file__).resolve().parents[1] / "_build" / "curves"


class Curve(NamedTuple):
    """One cost curve a driver ran: its name, its costs (the initial cost
    first) and the median host ms of an iteration after the first (None
    when the run had one iteration)."""
    name: str
    costs: list
    ms: Optional[float]


def committed_curve(name: str) -> np.ndarray:
    """The JAX package's committed curve ``examples/analysis/<name>.csv``."""
    return np.loadtxt(ANALYSIS_DIR / f"{name}.csv", ndmin=1)


def out_path(out_dir, name: str) -> Path:
    """``out_dir/name``, the directory made; raises for the committed
    curves' directory, which the port never writes."""
    out_dir = Path(out_dir)
    if out_dir.resolve() == ANALYSIS_DIR.resolve():
        raise ValueError(f"{ANALYSIS_DIR} holds the committed curves; the "
                         f"port never writes there")
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir / name


def save_cost_curve(name: str, cost_lst, out_dir=OUT_DIR) -> Path:
    """``np.savetxt`` of the per-iteration costs to ``out_dir/<name>.csv``,
    the format of the committed curves."""
    path = out_path(out_dir, f"{name}.csv")
    np.savetxt(path, np.asarray(cost_lst), delimiter=",")
    return path


def median_ms(walls) -> Optional[float]:
    """The median host ms of the iterations after the first (``iterate``'s
    seconds), or None for fewer than two."""
    return statistics.median(walls[1:]) * 1e3 if len(walls) > 1 else None


def iterate(solver, iterations: int) -> list:
    """``solver.iterate(iterations)``, one iteration at a time; returns the
    host seconds of each.  An iteration of either solver ends in the host
    read of its cost, so each time covers the device work it queued."""
    walls = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        solver.iterate(1, verbose=False)
        walls.append(time.perf_counter() - t0)
    return walls


def report(solver, name: str, walls=(), out_dir=OUT_DIR,
           save: bool = True) -> Curve:
    """Print the solver's initial, final and best cost and write its curve
    (unless ``save`` is false); ``walls`` are the host seconds of its
    iterations (``iterate``)."""
    ms = median_ms(walls)
    print(f"[{name}] initial cost: {solver.cost_lst[0]:.4f}  "
          f"final: {solver.cost:.4f}  best: {solver.cost_best:.4f}"
          + (f"  ({ms:.3f} ms an iteration after the first)"
             if ms is not None else ""), flush=True)
    if save:
        save_cost_curve(name, solver.cost_lst, out_dir)
    return Curve(name, list(solver.cost_lst), ms)
