"""A plan's problem as numbers, made by the benchmark from the
configuration's file, the traffic's and the plan's draw, and handed alike
to the program and to the reference: start and goal, cost matrices, input
bounds and the initial guess (the inputs that hold the actuated dofs where
they start, or, where the traffic names an end, a ramp from there to it
over the horizon, as the upstream's informed guesses are)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from . import traffic


class Problem(NamedTuple):
    x0: np.ndarray               # (n,)
    xd_trj: np.ndarray           # (T+1, n)
    u_init: np.ndarray           # (T, m)
    Q: np.ndarray                # (n, n)
    Qd: np.ndarray               # (n, n)
    R: np.ndarray                # (m, m)
    idx_u: np.ndarray            # (m,) actuated dofs, in input order
    unactuated: np.ndarray       # the other dofs
    u_bounds_rel: Optional[np.ndarray]   # (2, m) on u_t - u_{t-1}
    u_bounds_abs: Optional[np.ndarray]   # (2, m) on u_t (about the
    #                                       nominal under the trust region)


def diag_of(config: dict, groups: dict, scale: float = 1.0) -> np.ndarray:
    """diag of the per-group weights ``groups`` laid out by the
    configuration's layout (every dof of a group not listed is 0)."""
    d = traffic.x_from_q(config["layout"], groups, config["nq"])
    return np.diag(d * scale)


def make(config: dict, mix: dict, plan: traffic.Plan) -> Problem:
    layout, T, m = config["layout"], config["T"], config["m"]
    x0, xd = traffic.goal(config, layout, plan.goal_scale)
    idx_u = np.array([i for g in config["actuated"] for i in layout[g]],
                     np.int64)
    unact = np.array(sorted(set(range(config["nq"])) - set(idx_u)), np.int64)
    r = np.concatenate([config["R"][g] for g in config["actuated"]])

    def box(per_h):
        if per_h is None:
            return None
        v = np.ones(m) * per_h * config["factory_args"]["h"]
        return np.stack([-v, v])

    u_init = np.tile(x0[idx_u], (T, 1))
    if "u_init_ramp_to" in mix:
        end = np.concatenate([mix["u_init_ramp_to"][g]
                              for g in config["actuated"]])
        ramp = np.arange(1, T + 1, dtype=np.float64)[:, None] / T
        u_init = x0[idx_u][None] + (end - x0[idx_u])[None] * ramp
    return Problem(
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)), u_init=u_init,
        Q=diag_of(config, config["Q"]),
        Qd=diag_of(config, config["Q"], config["Qd_scale"]),
        R=np.diag(r), idx_u=idx_u, unactuated=unact,
        u_bounds_rel=box(config["u_bounds_rel_per_h"]),
        u_bounds_abs=box(config["u_bounds_abs_per_h"]))
