"""Box pushing with second-order dynamics, position-controlled.

The port of ``examples/box_pushing_second_order.py``: h=0.05, the pusher's
mass 0.3 and damping 1, the hand nearly touching the box, goal
+(0.3, 0.3), Δu cost, trust-region boxes of +-0.04, zero_order_AB with
damping 1e-5, 25 ADMM sweeps, 10 iterations; curve
``box_pushing_second_order_position``.
"""
import numpy as np

from .. import (IrsMpc, IrsMpcParams, Mbp2DModel, SmoothingConfig,
                make_box_pushing)
from .common import OUT_DIR, iterate, report


def build_solver(num_samples=50, T=60, gradient_mode="zero_order_AB",
                 seed=0, device="cuda"):
    mbp = Mbp2DModel(base=make_box_pushing(h=0.05), actuated_mass=(0.3, 0.3),
                     control_mode="position", damping=1.0)
    nq = mbp.nq
    q0 = np.array([0.0, 0.5, 0.0, 0.0, -0.11], np.float32)
    x0 = np.concatenate([q0, np.zeros(nq)])
    qd = np.array([0.3, 0.8, 0.0, 0.0, -0.11], np.float32)
    xd = np.concatenate([qd, np.zeros(nq)])
    Q = np.diag(np.concatenate([np.array([10.0, 10.0, 10.0, 1e-4, 1e-4]),
                                np.full(nq, 1e-4)]))
    idx_u = mbp.indices_u_into_x()
    params = IrsMpcParams(
        Q=Q, Qd=Q * 100, R=np.eye(2) * 1.0,
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(q0[idx_u], (T, 1)), indices_u_into_x=idx_u,
        u_bounds_abs=np.array([-np.ones(2) * 0.04, np.ones(2) * 0.04]),
        bounds_trust_region=True, unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False,
            damp=1e-5),
        admm_iters=25, report_final_cost_with_Q=False, seed=seed)
    return IrsMpc(mbp.system(), params, device=device), mbp


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    solver, _ = build_solver(device=device)
    return [report(solver, "box_pushing_second_order_position",
                   iterate(solver, 10), out_dir)]
