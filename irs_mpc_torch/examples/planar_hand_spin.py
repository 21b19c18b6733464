"""Planar hand "spin" task: rotate the ball -pi/4 while lowering it.

The port of ``examples/planar_hand_spin.py``: Q = [10, 1, 10] on the ball,
Qd = 10 Q, R = 1e2, inputs within +-1.0h of the nominal, std_u 0.1
decayed by 1/sqrt(it), 50 samples; 21 iterations of each of the four
modes, then the iCEM-class spin baseline for 40; curves
``planar_hand_spin_{exact,first_order,zero_order_B,zero_order_AB,cem}``.
"""
import numpy as np

from .. import (CemParams, CrossEntropyMethod, IrsMpc, IrsMpcParams,
                SmoothingConfig, make_planar_hand)
from .common import OUT_DIR, iterate, report
from .planar_hand import Q0

MODES = ("exact", "first_order", "zero_order_B", "zero_order_AB")
GOAL = np.array([0.0, -0.1, -np.pi / 4])

def _task(model, T):
    x0 = model.get_x_from_q_dict(Q0)
    xd = model.get_x_from_q_dict({"sphere": Q0["sphere"] + GOAL,
                                  "arm_left": Q0["arm_left"],
                                  "arm_right": Q0["arm_right"]})
    Q_dict = {"sphere": np.array([10.0, 1.0, 10.0]),
              "arm_left": np.array([1e-3, 1e-3]),
              "arm_right": np.array([1e-3, 1e-3])}
    Qd_dict = {k: v * 10 for k, v in Q_dict.items()}
    R_dict = {"arm_left": 1e2 * np.ones(2), "arm_right": 1e2 * np.ones(2)}
    return x0, np.tile(xd, (T + 1, 1)), Q_dict, Qd_dict, R_dict


def build_solver(gradient_mode="zero_order_B", num_samples=50, T=30,
                 device="cuda"):
    model = make_planar_hand(h=0.1)
    idx_u = model.indices_u_into_x()
    x0, xd_trj, Q_dict, Qd_dict, R_dict = _task(model, T)
    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict(Qd_dict),
        R=model.get_R_from_R_dict(R_dict),
        x0=x0, xd_trj=xd_trj, u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_abs=np.array([-np.ones(4) * 1.0 * model.h,
                               np.ones(4) * 1.0 * model.h]),
        bounds_trust_region=True, indices_u_into_x=idx_u,
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode, decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.5, decay_std_x=False),
        admm_iters=30, report_final_cost_with_Q=False,
        estimation_system=model.estimation_surrogate())
    return IrsMpc(model.system(), params, device=device), model


def build_cem_solver(T=30, batch_size=2000, n_elite=100, device="cuda"):
    """``examples/planar_hand_spin.py:76-106``: 2000 candidates, 100
    elites, AR(1) noise at 0.85, momentum 0.3, 10 persisted elites, std
    floor 0.02."""
    model = make_planar_hand(h=0.1)
    idx_u = model.indices_u_into_x()
    x0, xd_trj, Q_dict, Qd_dict, R_dict = _task(model, T)
    params = CemParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict(Qd_dict),
        R=model.get_R_from_R_dict(R_dict),
        x0=x0, xd_trj=xd_trj, u_trj_init=np.tile(x0[idx_u], (T, 1)),
        n_elite=n_elite, batch_size=batch_size,
        initial_std=np.ones(4) * 0.25, std_floor=np.float32(0.02),
        momentum=0.3, noise_beta=0.85, elite_keep=min(10, n_elite),
        indices_u_into_x=idx_u, report_final_cost_with_Q=False)
    return CrossEntropyMethod(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True, modes=MODES,
         num_iters=21):
    curves = []
    for mode in modes:
        solver, _ = build_solver(gradient_mode=mode, device=device)
        curves.append(report(solver, f"planar_hand_spin_{mode}",
                             iterate(solver, num_iters), out_dir))
    cem, _ = build_cem_solver(device=device)
    curves.append(report(cem, "planar_hand_spin_cem", iterate(cem, 40),
                         out_dir))
    return curves
