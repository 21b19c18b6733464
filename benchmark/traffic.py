"""The one generator of plans: every plan's goal and solver seed, drawn from
the run's seed and the plan's index alone.

A cell's traffic is one planner in a closed loop, plan after plan, as a
researcher or an MPC controller calls it.  Plan ``i`` of a run with seed
``s`` scales each coordinate of the configuration's goal displacement by a
factor drawn uniformly from the mix's ``goal_spread`` and gets its own
solver seed.  The work of a plan does not depend on the draw: every solve
runs a fixed number of iterations, so every seed gives the same sizes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Plan(NamedTuple):
    index: int
    goal_scale: np.ndarray       # (nq,) factor on each goal coordinate
    solver_seed: int


def plan(mix: dict, nq: int, seed: int, index: int) -> Plan:
    """Plan ``index`` of a run seeded ``seed`` (any whole number)."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, int(index)])
    lo, hi = mix["goal_spread"]
    scale = rng.uniform(lo, hi, size=nq)
    return Plan(index=index, goal_scale=scale,
                solver_seed=int(rng.integers(0, 2 ** 62)))


def x_from_q(layout: dict, q_dict: dict, nq: int) -> np.ndarray:
    """The (nq,) state of ``q_dict`` (name -> coordinates) under
    ``layout`` (name -> indices into the state)."""
    x = np.zeros(nq, np.float64)
    for name, idx in layout.items():
        x[list(idx)] = q_dict[name]
    return x


def goal(config: dict, layout: dict, scale: np.ndarray):
    """(x0, xd): the start state of the configuration and the goal state,
    the start plus the scaled goal displacement."""
    nq = config["nq"]
    x0 = x_from_q(layout, config["q0"], nq)
    disp = x_from_q(layout, config["goal_displacement"], nq)
    return x0, x0 + scale * disp


def decay(spec: dict, it):
    """The smoothing scale at the 1-based iteration ``it`` (a number or an
    f32 tensor): base**it / divide_by / it**power."""
    return spec["base"] ** it / spec["divide_by"] / it ** spec["power"]
