"""Carrots: many-object manipulation, 20 pieces swept toward a goal line.

The port of ``examples/carrots.py``: a 5-dof gripper and 20 pieces on the
ground (45 dof, 500 contact rows), h=1.0, the gripper's reference
sweeping through the pile, Δu cost, trust-region input boxes of +-0.15,
std_u 0.1 decayed by 1/it**0.8, 30 samples, 20 ADMM sweeps and no
estimation surrogate, 6 iterations; curve ``carrots_zero_order``.  The
model is past K2's and K4's limits, so an iteration launches K1 and K3
(n = 45 + 5, m = 5) and runs its contact solves as plain batched PyTorch.
"""
import numpy as np

from .. import IrsMpc, IrsMpcParams, SmoothingConfig, make_carrots
from .common import OUT_DIR, iterate, report


def build_solver(gradient_mode="zero_order_B", num_samples=30, T=10,
                 n_pieces=20, device="cuda"):
    model = make_carrots(n_pieces=n_pieces, h=1.0)
    idx_u = model.indices_u_into_x()
    rng = np.random.RandomState(0)
    q0 = {"gripper": np.array([-0.85, 0.22, 0.0, -0.05, -0.05])}
    for k in range(n_pieces):
        q0[f"carrot_{k}"] = np.array([rng.uniform(-0.6, 0.2), 0.05])
    x0 = model.get_x_from_q_dict(q0)
    xd_rows = []
    for t in range(T + 1):
        frac = t / max(T, 1)
        xd = {"gripper": np.array([-0.85 + 1.25 * frac, 0.22, 0.0, -0.05,
                                   -0.05])}
        for k in range(n_pieces):
            xd[f"carrot_{k}"] = np.array([0.4, 0.05])
        xd_rows.append(model.get_x_from_q_dict(xd))
    Q_dict = {"gripper": np.array([2.0, 0.5, 0.1, 0.1, 0.1])}
    for k in range(n_pieces):
        Q_dict[f"carrot_{k}"] = np.array([1.0, 0.1])
    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 10 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"gripper": np.full(5, 0.5)}),
        x0=x0, xd_trj=np.stack(xd_rows),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_abs=np.array([-np.full(5, 0.15), np.full(5, 0.15)]),
        bounds_trust_region=True, indices_u_into_x=idx_u,
        unactuated_indices=np.arange(5, 5 + 2 * n_pieces),
        gradient_mode=gradient_mode, decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        admm_iters=20, report_final_cost_with_Q=False)
    return IrsMpc(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    solver, _ = build_solver(device=device)
    return [report(solver, "carrots_zero_order", iterate(solver, 6),
                   out_dir)]
