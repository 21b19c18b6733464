"""Three-cart non-smooth collision system, zero-order with sample
projection.

The port of ``examples/three_cart.py``: h=0.05, T=100, carts from (0, 1, 2)
to +2 each (the middle one unactuated), 1000 samples projected onto the
non-penetration set, std (4.0, 0.5) decayed by 1/it**0.2, 20 iterations;
curve ``three_cart_zero_order``.
"""
import numpy as np

from .. import IrsMpc, IrsMpcParams, SmoothingConfig, make_three_cart
from .common import OUT_DIR, iterate, report


def build_params(T=100, num_samples=1000):
    w = np.array([50., 50., 50., 20., 100., 20.])
    return IrsMpcParams(
        Q=0.01 * np.diag(w), Qd=np.diag(w), R=0.01 * np.diag([1., 1.]),
        x0=np.array([0., 1., 2., 0., 0., 0.]),
        xd_trj=np.tile([2., 3., 4., 0., 0., 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1, -0.1], (T, 1)),
        u_bounds_abs=np.array([[-1000., -1000.], [1000., 1000.]]),
        gradient_mode="zero_order",
        smoothing=SmoothingConfig(num_samples=num_samples, std_x=4.0,
                                  std_u=0.5,
                                  decay=lambda it: 1.0 / it ** 0.2))


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    solver = IrsMpc(make_three_cart(0.05), build_params(), device=device)
    curves = [report(solver, "three_cart_zero_order", iterate(solver, 20),
                     out_dir)]
    if gifs:
        from ..utils.viz import animate_analytic_trajectory
        animate_analytic_trajectory("three_cart", solver.x_trj_best,
                                    out_dir / "three_cart.gif")
    return curves
