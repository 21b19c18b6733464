"""Box pushing: a point pusher slides a 1 m box to a goal pose.

The port of ``examples/box_pushing.py``: box at (0, 0.5, 0), hand at
(0, -0.2), goal box +(0.5, 0.5, -pi/4), running cost only (Qd = 0), Δu
cost, relative input bounds of +-0.4h, std_u 0.3 decayed by 0.3**it/0.3,
100 samples, 30 ADMM sweeps and the 15-iteration estimation surrogate; 21
iterations of each of the four modes, of exact mode from an informed
initial guess, and of three modes on the LCP contact model.  Curves
``box_pushing_{exact,first_order,zero_order_B,zero_order_AB}``,
``box_pushing_exact_good_guess`` and ``box_pushing_lcp_{exact,
zero_order_B,zero_order_AB}``.
"""
import dataclasses

import numpy as np

from .. import IrsMpc, IrsMpcParams, SmoothingConfig, make_box_pushing
from .common import OUT_DIR, iterate, report

MODES = ("exact", "first_order", "zero_order_B", "zero_order_AB")
LCP_MODES = ("exact", "zero_order_B", "zero_order_AB")
Q0 = {"box": np.array([0.0, 0.5, 0.0]), "hand": np.array([0.0, -0.2])}


def build_problem(gradient_mode="zero_order_B", num_samples=100, T=60,
                  contact_model="anitescu"):
    """The model and the solver's parameters of ``build_solver``."""
    model = make_box_pushing(h=0.1)
    if contact_model != "anitescu":
        model = dataclasses.replace(model, contact_model=contact_model)
    idx_u = model.indices_u_into_x()
    x0 = model.get_x_from_q_dict(Q0)
    xd = model.get_x_from_q_dict({
        "box": Q0["box"] + np.array([0.5, 0.5, -np.pi / 4]),
        "hand": Q0["hand"]})
    Q_dict = {"box": np.array([3.0, 3.0, 1.2]), "hand": np.zeros(2)}
    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 0 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"hand": 1e1 * np.ones(2)}),
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_rel=np.array([-np.ones(2) * 0.4 * model.h,
                               np.ones(2) * 0.4 * model.h]),
        indices_u_into_x=idx_u, unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode, decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.3, std_x=1e-3,
            decay=lambda it: 0.3 ** it / 0.3, decay_std_x=False),
        admm_iters=30, report_final_cost_with_Q=False,
        estimation_system=model.estimation_surrogate())
    return model, params


def build_solver(gradient_mode="zero_order_B", num_samples=100, T=60,
                 contact_model="anitescu", device="cuda"):
    model, params = build_problem(gradient_mode, num_samples, T,
                                  contact_model)
    return IrsMpc(model.system(), params, device=device), model


def build_good_guess_solver(T=60, device="cuda"):
    """``examples/box_pushing.py:79-97``: exact gradients from an informed
    initial guess, the hand ramped from its start to (0.45, 0.3), so that
    the nominal trajectory is in contact from the start."""
    model, params = build_problem(gradient_mode="exact", T=T)
    start, end = np.array([0.0, -0.2]), np.array([0.45, 0.3])
    ramp = start[None] + (end - start)[None] * (
        np.arange(1, T + 1, dtype=np.float64) / T)[:, None]
    params = dataclasses.replace(params, u_trj_init=ramp.astype(np.float32))
    return IrsMpc(model.system(), params, device=device), model


def build_lcp_solver(gradient_mode, device="cuda"):
    """``examples/box_pushing.py:117-138``: the task on the LCP contact
    model.  Its one-step map is gated on the gap at the start of the
    step, so the exact gradient and input-only bundling (zero_order_B) are
    zero until touch; zero_order_AB bundles over the state as well, with
    the hand-to-box coupling kept in A (``decouple_AB=False``) and std_x
    0.1 decayed with std_u."""
    model, params = build_problem(gradient_mode=gradient_mode,
                                  contact_model="lcp")
    if gradient_mode == "zero_order_AB":
        params = dataclasses.replace(
            params, decouple_AB=False, smoothing=dataclasses.replace(
                params.smoothing, std_x=0.1, decay_std_x=True))
    return IrsMpc(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True, modes=MODES,
         num_iters=21):
    curves = []
    for mode in modes:
        solver, _ = build_solver(gradient_mode=mode, device=device)
        curves.append(report(solver, f"box_pushing_{mode}",
                             iterate(solver, num_iters), out_dir))
    solver, _ = build_good_guess_solver(device=device)
    curves.append(report(solver, "box_pushing_exact_good_guess",
                         iterate(solver, num_iters), out_dir))
    for mode in LCP_MODES:
        solver, _ = build_lcp_solver(mode, device=device)
        curves.append(report(solver, f"box_pushing_lcp_{mode}",
                             iterate(solver, num_iters), out_dir))
    return curves
