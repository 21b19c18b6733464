"""Bicycle trajectory optimisation, easy and hard goal, every estimator.

The port of ``examples/bicycle.py``: T=100, a steering state bound of
+-pi/4, 2000 samples with per-dim stds; 12 iterations to the easy goal and
26 to the hard one, then the CEM for 10 and 25; curves
``bicycle_{easy,hard}_{exact,first_order,zero_order,cem}``.
"""
import numpy as np

from .. import (CemParams, CrossEntropyMethod, IrsMpc, IrsMpcParams,
                SmoothingConfig, make_bicycle)
from .common import OUT_DIR, iterate, report

MODES = ("exact", "first_order", "zero_order")


def goal(hard):
    """Ahead-left quarter turn (easy) or behind the car (hard)."""
    return (np.array([-3., -1., -np.pi / 2, 0., 0.]) if hard
            else np.array([3., 1., np.pi / 2, 0., 0.]))


def build_params(mode, hard=False, num_samples=2000):
    T = 100
    return IrsMpcParams(
        Q=np.diag([5., 5., 3., 0.1, 0.1]),
        Qd=np.diag([50., 50., 30., 1., 1.]), R=np.diag([1., 0.1]),
        x0=np.zeros(5), xd_trj=np.tile(goal(hard), (T + 1, 1)),
        u_trj_init=np.tile([0.1, 0.0], (T, 1)),
        x_bounds_abs=np.array([[-1e4, -1e4, -1e4, -1e4, -np.pi / 4],
                               [1e4, 1e4, 1e4, 1e4, np.pi / 4]]),
        u_bounds_abs=np.array([[-1e4, -1e4], [1e4, 1e4]]),
        gradient_mode=mode, admm_iters=40,
        smoothing=SmoothingConfig(num_samples=num_samples,
                                  std_x=np.array([2., 2., 1., 2., 0.01]),
                                  std_u=np.array([2., 1.])))


def build_cem_solver(hard=False, T=100, batch_size=100, n_elite=10,
                     device="cuda"):
    """``examples/bicycle.py:42-59``: 100 candidates, 10 elites, initial
    std (1, 1)."""
    params = CemParams(
        Q=np.diag([5., 5., 3., 0.1, 0.1]),
        Qd=np.diag([50., 50., 30., 1., 1.]), R=np.diag([1., 0.1]),
        x0=np.zeros(5), xd_trj=np.tile(goal(hard), (T + 1, 1)),
        u_trj_init=np.tile([0.1, 0.0], (T, 1)),
        initial_std=np.array([1.0, 1.0]), batch_size=batch_size,
        n_elite=n_elite)
    return CrossEntropyMethod(make_bicycle(0.1), params, device=device)


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    bike = make_bicycle(0.1)
    curves = []
    for hard in (False, True):
        tag = "hard" if hard else "easy"
        for mode in MODES:
            solver = IrsMpc(bike, build_params(mode, hard), device=device)
            curves.append(report(solver, f"bicycle_{tag}_{mode}",
                                 iterate(solver, 26 if hard else 12),
                                 out_dir))
        cem = build_cem_solver(hard, device=device)
        curves.append(report(cem, f"bicycle_{tag}_cem",
                             iterate(cem, 25 if hard else 10), out_dir))
    return curves
