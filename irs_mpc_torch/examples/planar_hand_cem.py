"""Planar hand with the CEM baseline (contact-rich CEM).

The port of ``examples/planar_hand_cem.py``: the task of ``planar_hand``,
2000 candidates, 100 elites, 40 iterations; curve ``planar_hand_cem``.  On
the card the population and the refit mean are open-loop lanes of K4.
"""
import numpy as np

from .. import CemParams, CrossEntropyMethod, make_planar_hand
from .common import OUT_DIR, iterate, report
from .planar_hand import Q0


def build_solver(T=30, batch_size=2000, n_elite=100, device="cuda"):
    """``examples/planar_hand_cem.py:14-63``: initial std 0.25, std floor
    0.02, momentum 0.3, AR(1) noise at 0.85, 10 persisted elites, Δu
    cost."""
    model = make_planar_hand(h=0.1)
    idx_u = model.indices_u_into_x()
    x0 = model.get_x_from_q_dict(Q0)
    xd = model.get_x_from_q_dict({
        "sphere": Q0["sphere"] + np.array([0.3, -0.1, 0.5]),
        "arm_left": Q0["arm_left"], "arm_right": Q0["arm_right"]})
    Q_dict = {"sphere": np.array([1e-3, 1e-3, 10.0]),
              "arm_left": np.array([1e-3, 1e-3]),
              "arm_right": np.array([1e-3, 1e-3])}
    params = CemParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 100 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"arm_left": 5 * np.ones(2),
                                   "arm_right": 5 * np.ones(2)}),
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        n_elite=n_elite, batch_size=batch_size,
        initial_std=np.ones(4) * 0.25, std_floor=np.float32(0.02),
        momentum=0.3, noise_beta=0.85, elite_keep=min(10, n_elite),
        indices_u_into_x=idx_u, report_final_cost_with_Q=False)
    return CrossEntropyMethod(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    solver, _ = build_solver(device=device)
    return [report(solver, "planar_hand_cem", iterate(solver, 40), out_dir)]
