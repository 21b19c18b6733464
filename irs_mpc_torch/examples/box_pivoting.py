"""Box pivoting: push a box so that it pivots against a wall under gravity.

The port of ``examples/box_pivoting.py``: box resting against the wall at
(0.45, 0.5, 0), hand at (-0.17, 0.8), goal a -30 degree pivot about the
bottom corner at the wall, Δu cost, trust-region input boxes of +-0.6h,
std_u 0.1 decayed by 1/it**0.8, 30 ADMM sweeps, the 15-iteration
estimation surrogate, the model canonicalising its warm duals; 10
iterations of each of three modes, then the CEM for 20.  Curves
``box_pivoting_{exact,first_order,zero_order,cem}`` (zero_order_B writes
``box_pivoting_zero_order``, as the JAX driver names it).
"""
import dataclasses

import numpy as np

from .. import (CemParams, CrossEntropyMethod, IrsMpc, IrsMpcParams,
                SmoothingConfig, make_box_pivoting)
from .common import OUT_DIR, iterate, report

MODES = ("exact", "first_order", "zero_order_B")


def _task(model, T):
    q0 = {"box": np.array([0.45, 0.5, 0.0]), "hand": np.array([-0.17, 0.8])}
    x0 = model.get_x_from_q_dict(q0)
    xd = model.get_x_from_q_dict({"box": np.array([0.767, 0.683,
                                                   -np.pi / 6]),
                                  "hand": q0["hand"]})
    Q_dict = {"box": np.array([1.0, 1.0, 20.0]),
              "hand": np.array([1e-4, 1e-4])}
    return dict(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 100 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"hand": np.array([0.5, 0.5])}),
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(x0[model.indices_u_into_x()], (T, 1)),
        indices_u_into_x=model.indices_u_into_x(),
        report_final_cost_with_Q=False)


def build_solver(gradient_mode="zero_order_B", num_samples=100, T=40,
                 device="cuda"):
    model = make_box_pivoting(h=0.05)
    params = IrsMpcParams(
        **_task(model, T),
        u_bounds_abs=np.array([-np.ones(2) * 0.6 * model.h,
                               np.ones(2) * 0.6 * model.h]),
        bounds_trust_region=True, unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode, decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        admm_iters=30, estimation_system=model.estimation_surrogate())
    return IrsMpc(model.system(), params, device=device), model


def build_cem_solver(T=40, batch_size=100, n_elite=5, device="cuda"):
    """``examples/box_pivoting.py:63-102``: 100 candidates, 5 elites,
    initial std 0.05, Δu cost, on the model WITHOUT the canonical warm
    duals that the iRS factory opts into (the JAX example's choice for its
    CEM), so ``chain_gate`` keeps K4 off it.  Returns the CEM and that
    model."""
    model = dataclasses.replace(make_box_pivoting(h=0.05),
                                canon_warm_duals=False)
    params = CemParams(**_task(model, T), n_elite=n_elite,
                       batch_size=batch_size, initial_std=np.ones(2) * 0.05)
    return CrossEntropyMethod(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True, modes=MODES,
         num_iters=10):
    curves = []
    for mode in modes:
        solver, _ = build_solver(gradient_mode=mode, device=device)
        name = ("box_pivoting_zero_order" if mode.startswith("zero")
                else f"box_pivoting_{mode}")
        curves.append(report(solver, name, iterate(solver, num_iters),
                             out_dir))
    cem, _ = build_cem_solver(device=device)
    curves.append(report(cem, "box_pivoting_cem", iterate(cem, 20), out_dir))
    return curves
