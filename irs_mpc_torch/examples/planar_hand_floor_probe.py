"""The hold and exact-polish probes of the quasistatic planar-hand floor.

The port of ``examples/planar_hand_floor_probe.py`` (``PARITY.md``,
"Quasistatic planar-hand floor analysis"), at its stages and budgets:

0. the CEM bracket: ``planar_hand_cem``'s search, 40 refits, and how far
   its best trajectory's inputs lie from the achieved arm states
   (``du_stats``) against the trust region's 0.5h;
1. hold: iRS (zero_order_B) from the CEM inputs with the std schedule
   continued from its 21-descent value, ``decay(it) = 1/(it+20)^0.8``,
   ``decay_std_x=False``, 21 descents;
2. the standard 21-descent zero_order_B run;
3. exact polish from the standard run's and from the CEM's inputs, 15
   descents each, in a +-2h box that never clips them.

    python -m irs_mpc_torch.examples.planar_hand_floor_probe [--check]
        [--out DIR] [--cpu]

Curves ``planar_hand_{hold,polish,cem_polish}_probe.csv`` and the inputs
``planar_hand_u_{cem,std}.npy`` go to ``--out`` (never to the committed
``examples/analysis/``); the summary dict is printed and returned.  On the
card the iRS stages run K1-K4 and the CEM scores its population on K4.
"""
from __future__ import annotations

import sys

import numpy as np

from .. import SmoothingConfig
from . import planar_hand, planar_hand_cem
from .common import OUT_DIR, iterate, median_ms, out_path, report


def du_stats(model, x, u):
    """max |u_t - x_t[idx_u]| of a trajectory, and the share of its
    knot-dofs past the trust bound 0.5h."""
    idx = model.indices_u_into_x()
    du = np.abs(np.asarray(u) - np.asarray(x)[:-1][:, idx])
    return float(du.max()), float((du > 0.5 * model.h).mean())


def _numpy(t):
    return t.detach().cpu().numpy()


def hold_decay(it):
    """The hold stage's schedule, continued from the 21-descent value."""
    return 1.0 / (it + 20.0) ** 0.8


def main(out_dir=OUT_DIR, device="cuda", cem_iters=40, descents=21,
         polish_descents=15):
    """Run the probe; returns the summary dict (the JAX study's keys, and
    each stage's curve and median ms an iteration)."""
    # ---- stage 0: the CEM bracket --------------------------------------
    cem, model = planar_hand_cem.build_solver(device=device)
    cem_walls = iterate(cem, cem_iters)
    u_cem = _numpy(cem.u_trj_best).astype(np.float32)
    np.save(out_path(out_dir, "planar_hand_u_cem.npy"), u_cem)
    du_max, frac = du_stats(model, _numpy(cem.x_trj_best), u_cem)
    print(f"[cem] best {cem.cost_best:.3f}; max|du| {du_max:.4f} vs trust "
          f"bound {0.5 * model.h:.3f}; saturated knot-dofs {frac:.1%}",
          flush=True)

    # ---- hold under the continued schedule -----------------------------
    hold, _ = planar_hand.build_solver(
        gradient_mode="zero_order_B", device=device, u_trj_init=u_cem,
        smoothing=SmoothingConfig(num_samples=50, std_u=0.3, std_x=1e-3,
                                  decay=hold_decay, decay_std_x=False))
    hold_c = report(hold, "planar_hand_hold_probe", iterate(hold, descents),
                    out_dir)
    print(f"[hold] init {hold.cost_lst[0]:.3f} final {hold.cost:.3f} best "
          f"{hold.cost_best:.3f}", flush=True)

    # ---- the standard 21-descent run -----------------------------------
    std_run, _ = planar_hand.build_solver(gradient_mode="zero_order_B",
                                          device=device)
    std_walls = iterate(std_run, descents)
    u_std = _numpy(std_run.u_trj_best).astype(np.float32)
    np.save(out_path(out_dir, "planar_hand_u_std.npy"), u_std)
    sdu_max, sfrac = du_stats(model, _numpy(std_run.x_trj_best), u_std)
    print(f"[standard] best {std_run.cost_best:.3f}; max|du| {sdu_max:.4f}; "
          f"saturated {sfrac:.1%}", flush=True)

    # ---- exact polish in a wide trust region ---------------------------
    wide = np.array([-np.ones(4) * 2.0 * model.h, np.ones(4) * 2.0 * model.h])
    polish, _ = planar_hand.build_solver(gradient_mode="exact", device=device,
                                         u_trj_init=u_std, u_bounds_abs=wide)
    polish_c = report(polish, "planar_hand_polish_probe",
                      iterate(polish, polish_descents), out_dir)
    print(f"[polish std] init {polish.cost_lst[0]:.3f} final "
          f"{polish.cost:.3f} best {polish.cost_best:.3f}", flush=True)
    cem_polish, _ = planar_hand.build_solver(
        gradient_mode="exact", device=device, u_trj_init=u_cem,
        u_bounds_abs=wide)
    cem_polish_c = report(cem_polish, "planar_hand_cem_polish_probe",
                          iterate(cem_polish, polish_descents), out_dir)
    print(f"[polish cem] init {cem_polish.cost_lst[0]:.3f} final "
          f"{cem_polish.cost:.3f} best {cem_polish.cost_best:.3f}",
          flush=True)

    summary = {"cem_bracket": round(cem.cost_best, 3),
               "cem_du_max": round(du_max, 4),
               "cem_du_saturated_frac": round(frac, 3),
               "hold_best": round(hold.cost_best, 3),
               "hold_final": round(hold.cost, 3),
               "standard_best": round(std_run.cost_best, 3),
               "standard_du_max": round(sdu_max, 4),
               "polish_std_best": round(polish.cost_best, 3),
               "polish_std_final": round(polish.cost, 3),
               "polish_cem_best": round(cem_polish.cost_best, 3),
               "polish_cem_final": round(cem_polish.cost, 3)}
    print("\nsummary:", summary, flush=True)
    curves = {"cem": cem.cost_lst, "hold": hold_c.costs,
              "standard": std_run.cost_lst, "polish": polish_c.costs,
              "cem_polish": cem_polish_c.costs}
    ms = {"cem": median_ms(cem_walls), "hold": hold_c.ms,
          "standard": median_ms(std_walls), "polish": polish_c.ms,
          "cem_polish": cem_polish_c.ms}
    return dict(summary, curves={k: [float(c) for c in v]
                                 for k, v in curves.items()}, ms=ms,
                trust_bound=0.5 * model.h)


if __name__ == "__main__":
    from .run_all import study_cli
    sys.exit(study_cli("planar_hand_floor_probe"))
