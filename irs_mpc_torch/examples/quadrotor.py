"""Quadrotor 12-state helix tracking and CEM.

The port of ``examples/quadrotor.py``: h=0.05, T=200, the rising helix,
Q = diag(10 x6, 0 x6), Qd = 10 diag(10 x6, 1 x6), R = I, hover inputs
2.0, std 0.1 decayed by 1/sqrt(it), 1000 samples, 7 iterations of each
mode; then the CEM at 16000 candidates for 1200 iterations; curves
``quadrotor_{exact,first_order,zero_order,cem}``.
"""
import numpy as np

from .. import (CemParams, CrossEntropyMethod, IrsMpc, IrsMpcParams,
                SmoothingConfig, make_quadrotor)
from .common import OUT_DIR, iterate, report

MODES = ("exact", "first_order", "zero_order")


def helix_xd(T):
    """The rising helix (1.5 cos 0.05i, 1.5 sin 0.05i, 0.02i)."""
    i = np.arange(T + 1)
    xd = np.zeros((T + 1, 12))
    xd[:, 0], xd[:, 1], xd[:, 2] = (1.5 * np.cos(0.05 * i),
                                    1.5 * np.sin(0.05 * i), 0.02 * i)
    return xd


def build_params(mode, T=200, num_samples=1000):
    return IrsMpcParams(
        Q=np.diag([10.] * 6 + [0.] * 6),
        Qd=10.0 * np.diag([10.] * 6 + [1.] * 6), R=np.eye(4),
        x0=np.zeros(12), xd_trj=helix_xd(T),
        u_trj_init=np.tile([2.0] * 4, (T, 1)), gradient_mode=mode,
        smoothing=SmoothingConfig(num_samples=num_samples, std_x=0.1,
                                  std_u=0.1))


def build_cem_solver(T=200, batch_size=16000, n_elite=160, device="cuda"):
    """``examples/quadrotor.py:53-78``: 16000 candidates, 160 elites,
    initial std 0.02, thrusts clipped to [0, 4], AR(1) noise at 0.5,
    momentum 0.1, 20 persisted elites."""
    params = CemParams(
        Q=np.diag([10.] * 6 + [0.] * 6),
        Qd=10.0 * np.diag([10.] * 6 + [1.] * 6), R=np.eye(4),
        x0=np.zeros(12), xd_trj=helix_xd(T),
        u_trj_init=np.tile([2.0] * 4, (T, 1)), n_elite=n_elite,
        batch_size=batch_size, initial_std=np.ones(4) * 0.02,
        noise_beta=0.5, momentum=0.1, elite_keep=20,
        u_bounds_abs=np.array([np.zeros(4), 4.0 * np.ones(4)]))
    return CrossEntropyMethod(make_quadrotor(0.05), params, device=device)


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    quad = make_quadrotor(0.05)
    curves = []
    for mode in MODES:
        solver = IrsMpc(quad, build_params(mode), device=device)
        curves.append(report(solver, f"quadrotor_{mode}",
                             iterate(solver, 7), out_dir))
    if gifs:
        from ..utils.viz import animate_analytic_trajectory
        animate_analytic_trajectory("quadrotor", solver.x_trj_best,
                                    out_dir / "quadrotor.gif")
    cem = build_cem_solver(device=device)
    curves.append(report(cem, "quadrotor_cem", iterate(cem, 1200), out_dir))
    return curves
