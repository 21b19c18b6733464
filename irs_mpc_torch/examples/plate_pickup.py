"""Plate pickup: a gripper grasps a plate off the ground and lifts it.

The port of ``examples/plate_pickup.py``: a gripper (5 dof, two prismatic
fingers) over a plate on the ground, a staged reference (squeeze in the
first third, then lift 0.3), Δu cost, relative input bounds of +-0.06,
std_u 0.1 decayed by 1/it**0.8, 100 samples, 30 ADMM sweeps and the
15-iteration estimation surrogate, 10 iterations; curve
``plate_pickup_zero_order``.  ``chain_gate`` keeps K4 off its prismatic
fingers, as in the JAX package, so its line search runs the plain warm
chain.
"""
import numpy as np

from .. import IrsMpc, IrsMpcParams, SmoothingConfig, make_plate_pickup
from .common import OUT_DIR, iterate, report

# The golden of ``tests/test_golden_contact.py:38``: initial cost 482.9550
# and the best within 12 % of 3.216 after 8 descents.  The best depends on
# the random stream: on some streams the line search stalls near 3.6-4.1
# for the rest of the descents (the JAX package on the CPU, seeds 0-5:
# 3.197, 3.304, 3.185, 3.206, 3.683, 3.339; on the card, seeds 0-31
# (``irs_mpc_torch/tools/probe_plate_seeds.py``): median 3.4486 and 23 of
# 32 within 12 % with K2, 3.4679 and 23 of 32 with the plain PDIP on the
# same streams).  So it is held on the median best over seeds 0-15.
GOLDEN_ITERATIONS, GOLDEN_INITIAL, GOLDEN_BEST = 8, 482.9550, 3.216
GOLDEN_RTOL, GOLDEN_SEEDS = 0.12, tuple(range(16))


def build_solver(gradient_mode="zero_order_B", num_samples=100, T=30,
                 seed=0, device="cuda"):
    model = make_plate_pickup(h=0.1)
    idx_u = model.indices_u_into_x()
    q0 = {"plate": np.array([0.0, 0.04, 0.0]),
          "gripper": np.array([0.0, 0.30, 0.0, -0.16, -0.16])}
    x0 = model.get_x_from_q_dict(q0)
    T1 = T // 3
    xd_rows = []
    for t in range(T + 1):
        lift = 0.0 if t <= T1 else 0.3 * (t - T1) / max(T - T1, 1)
        xd_rows.append(model.get_x_from_q_dict({
            "plate": np.array([0.0, 0.04 + lift, 0.0]),
            "gripper": np.array([0.0, 0.30 + lift, 0.0, 0.02, 0.02])}))
    Q_dict = {"plate": np.array([1.0, 50.0, 5.0]),
              "gripper": np.array([0.1, 0.1, 0.1, 0.5, 0.5])}
    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 100 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"gripper": np.array([1.0, 1.0, 1.0, 0.2,
                                                        0.2])}),
        x0=x0, xd_trj=np.stack(xd_rows),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_rel=np.array([-np.ones(5) * 0.06, np.ones(5) * 0.06]),
        indices_u_into_x=idx_u, unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode, decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        admm_iters=30, report_final_cost_with_Q=False,
        estimation_system=model.estimation_surrogate(), seed=seed)
    return IrsMpc(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    solver, _ = build_solver(device=device)
    return [report(solver, "plate_pickup_zero_order", iterate(solver, 10),
                   out_dir)]
