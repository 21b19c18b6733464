"""Pendulum swing-up with exact / first-order / zero-order smoothing and CEM.

The port of ``examples/pendulum.py``: T=200, h=0.05, Q=I, Qd=20I, R=I,
1000 samples a knot, 10 iterations of each mode, then the CEM at 8000
candidates for 150 iterations; curves ``pendulum_{exact,first_order,
zero_order,cem}``.
"""
import numpy as np

from .. import (CemParams, CrossEntropyMethod, IrsMpc, IrsMpcParams,
                SmoothingConfig, make_pendulum)
from .common import OUT_DIR, iterate, report

MODES = ("exact", "first_order", "zero_order")


def build_params(mode="zero_order", T=200, num_samples=1000, **kw):
    """The swing-up (std 1 a sample); ``kw`` sets further IrsMpcParams
    fields (``parallel_riccati``, ``mesh``)."""
    return IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode=mode,
        smoothing=SmoothingConfig(num_samples=num_samples, std_x=1.0,
                                  std_u=1.0), **kw)


def build_cem_solver(T=200, batch_size=8000, n_elite=80, device="cuda"):
    """``examples/pendulum.py:49-55``: 8000 candidates, 80 elites, initial
    std 1, 10 persisted elites, noise interpolated from 40 knots."""
    params = CemParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), n_elite=n_elite,
        batch_size=batch_size, initial_std=np.array([1.0]), elite_keep=10,
        noise_knots=40)
    return CrossEntropyMethod(make_pendulum(0.05), params, device=device)


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    pend = make_pendulum(0.05)
    curves = []
    for mode in MODES:
        solver = IrsMpc(pend, build_params(mode), device=device)
        curves.append(report(solver, f"pendulum_{mode}",
                             iterate(solver, 10), out_dir))
    if gifs:
        from ..utils.viz import animate_analytic_trajectory
        animate_analytic_trajectory("pendulum", solver.x_trj_best,
                                    out_dir / "pendulum.gif")
    cem = build_cem_solver(device=device)
    curves.append(report(cem, "pendulum_cem", iterate(cem, 150), out_dir))
    return curves
