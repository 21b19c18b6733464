"""Planar hand: two 2-link arms reposition and rotate a ball.

The port of ``examples/planar_hand.py`` (also ``bench.py::
build_planar_hand_solver``): move the ball by (+0.3, -0.1) and rotate it
+0.5, Δu cost, trust-region input boxes of +-0.5h, std_u 0.3 decayed by
1/it**0.8, 50 samples, decoupled A/B, boxed ADMM at 12 over-relaxed
sweeps and the 15-iteration estimation surrogate; 21 iterations of each
of the four modes, curves ``planar_hand_{exact,first_order,zero_order_B,
zero_order_AB}``.
"""
import dataclasses

import numpy as np

from .. import IrsMpc, IrsMpcParams, SmoothingConfig, make_planar_hand
from .common import OUT_DIR, iterate, report

MODES = ("exact", "first_order", "zero_order_B", "zero_order_AB")
# The ball resting between the upturned arms.
Q0 = {"sphere": np.array([0.0, 0.35, 0.0]),
      "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
      "arm_right": np.array([np.pi / 4, np.pi / 4])}


def build_solver(gradient_mode="zero_order_B", num_samples=50, T=30,
                 num_iters_hint=10, device="cuda", **overrides):
    """``overrides`` are applied onto the assembled IrsMpcParams
    (``dataclasses.replace``), e.g. ``forward_mode="resolve"``."""
    model = make_planar_hand(h=0.1)
    idx_u = model.indices_u_into_x()
    x0 = model.get_x_from_q_dict(Q0)
    xd = model.get_x_from_q_dict({
        "sphere": Q0["sphere"] + np.array([0.3, -0.1, 0.5]),
        "arm_left": Q0["arm_left"], "arm_right": Q0["arm_right"]})
    Q_dict = {"sphere": np.array([1e-3, 1e-3, 10.0]),
              "arm_left": np.array([1e-3, 1e-3]),
              "arm_right": np.array([1e-3, 1e-3])}
    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 100 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"arm_left": 5 * np.ones(2),
                                   "arm_right": 5 * np.ones(2)}),
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_abs=np.array([-np.ones(4) * 0.5 * model.h,
                               np.ones(4) * 0.5 * model.h]),
        bounds_trust_region=True, indices_u_into_x=idx_u,
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode, decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.3, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        admm_iters=12, admm_over_relax=1.6, report_final_cost_with_Q=False,
        estimation_system=model.estimation_surrogate())
    if overrides:
        params = dataclasses.replace(params, **overrides)
    return IrsMpc(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True, modes=MODES,
         num_iters=21):
    curves = []
    for mode in modes:
        solver, _ = build_solver(gradient_mode=mode, device=device)
        curves.append(report(solver, f"planar_hand_{mode}",
                             iterate(solver, num_iters), out_dir))
    return curves
