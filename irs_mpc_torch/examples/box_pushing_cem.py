"""Box pushing with the CEM baseline.

The port of ``examples/box_pushing_cem.py``: the task of ``box_pushing``,
100 candidates, 5 elites, initial std 0.2, Δu cost, 15 iterations; curve
``box_pushing_cem``.  On the card the population and the refit mean are
open-loop lanes of K4.
"""
import numpy as np

from .. import CemParams, CrossEntropyMethod, make_box_pushing
from .box_pushing import Q0
from .common import OUT_DIR, iterate, report


def build_solver(T=60, batch_size=100, n_elite=5, device="cuda"):
    model = make_box_pushing(h=0.1)
    idx_u = model.indices_u_into_x()
    x0 = model.get_x_from_q_dict(Q0)
    xd = model.get_x_from_q_dict({
        "box": Q0["box"] + np.array([0.5, 0.5, -np.pi / 4]),
        "hand": Q0["hand"]})
    Q_dict = {"box": np.array([3.0, 3.0, 1.2]), "hand": np.zeros(2)}
    params = CemParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 0 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"hand": 1e1 * np.ones(2)}),
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        n_elite=n_elite, batch_size=batch_size,
        initial_std=np.ones(2) * 0.2, indices_u_into_x=idx_u,
        report_final_cost_with_Q=False)
    return CrossEntropyMethod(model.system(), params, device=device), model


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    solver, _ = build_solver(device=device)
    return [report(solver, "box_pushing_cem", iterate(solver, 15), out_dir)]
