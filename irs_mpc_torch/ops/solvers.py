"""Trajectory-QP backend registry.

The port's copy of the JAX package's ``ops/solvers.py``: the reference's
``get_solver`` (which maps names to external QP solvers) becomes a map from
names to the port's own solve strategies.  The reference's solver names
are accepted as aliases of the nearest strategy, so that ported drivers
keep working.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    kind: str            # "riccati" | "riccati_parallel" | "admm"
    description: str


_REGISTRY = {
    "riccati": SolverSpec("riccati", "riccati",
                          "sequential Riccati pass (unconstrained, exact)"),
    "riccati_parallel": SolverSpec(
        "riccati_parallel", "riccati_parallel",
        "associative-scan Riccati, O(log T) depth"),
    "admm": SolverSpec("admm", "admm",
                       "boxed QP via ADMM with Riccati inner solves"),
}

# Reference names -> the nearest strategy (OSQP is ADMM; the others are
# general QP solvers, whose boxed problems ADMM solves here).
_ALIASES = {
    "osqp": "admm",
    "gurobi": "admm",
    "scs": "admm",
    "clp": "admm",
    "snopt": "admm",
}


def get_solver(name: str) -> SolverSpec:
    key = name.lower()
    key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(
            f"Do not recognize solver {name!r}; known: "
            f"{sorted(_REGISTRY) + sorted(_ALIASES)}")
    return _REGISTRY[key]
