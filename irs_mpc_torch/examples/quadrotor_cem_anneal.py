"""Annealed band-limited CEM on the quadrotor helix.

The port of ``examples/quadrotor_cem_anneal.py``: three CEM phases on the
800-dimensional helix search, 16000 candidates x T=200, 400 refits each,
``noise_knots`` 20, 67 and 0 (coarse, mid-band, per-knot), phase i seeded
with i.  Each phase starts from the previous phase's best input
trajectory and its refit per-knot std floored at 0.005
(``CemParams.initial_std`` takes a (T, m) array), and the phases' cost
curves are concatenated (the first phase's initial cost kept, the later
phases' dropped).  The committed run's phase bests are 22967 -> 11024 ->
9250 (``examples/analysis/quadrotor_cem_anneal.csv``).

    python -m irs_mpc_torch.examples.quadrotor_cem_anneal [--check]
        [--out DIR] [--cpu]

The curve ``quadrotor_cem_anneal.csv`` goes to ``--out``.  About 16 min a
run on the card (the quadrotor CEM at ~0.8 s a refit).
"""
from __future__ import annotations

import sys

import numpy as np

from .. import CemParams, CrossEntropyMethod, make_quadrotor
from .common import OUT_DIR, iterate, median_ms, save_cost_curve
from .quadrotor import helix_xd

NOISE_KNOTS, PHASE_ITERS, STD_FLOOR = (20, 67, 0), 400, 0.005


def build(T=200, batch_size=16000, n_elite=160, noise_knots=0,
          u_trj_init=None, initial_std=None, seed=0, device="cuda"):
    """``examples/quadrotor_cem_anneal.py:build``: the quadrotor CEM of
    ``quadrotor.build_cem_solver`` with the phase's noise knots, seed,
    initial mean and initial std (hover inputs 2.0 and 0.02 by default)."""
    return CrossEntropyMethod(make_quadrotor(0.05), CemParams(
        Q=1.0 * np.diag([10.] * 6 + [0.] * 6),
        Qd=10.0 * np.diag([10.] * 6 + [1.] * 6), R=np.eye(4),
        x0=np.zeros(12), xd_trj=helix_xd(T),
        u_trj_init=(np.tile([2.0] * 4, (T, 1)) if u_trj_init is None
                    else u_trj_init),
        n_elite=n_elite, batch_size=batch_size,
        initial_std=(np.ones(4) * 0.02 if initial_std is None
                     else initial_std),
        noise_beta=0.5, momentum=0.1, elite_keep=min(20, n_elite),
        noise_knots=noise_knots,
        u_bounds_abs=np.array([np.zeros(4), 4.0 * np.ones(4)]),
        seed=seed), device=device)


def handoff(u_trj_best, std_trj):
    """The next phase's initial mean and std: the best input trajectory,
    and the refit std floored at STD_FLOOR (exploration headroom)."""
    u = np.asarray(u_trj_best, np.float32)
    return u, np.maximum(np.asarray(std_trj, np.float32), STD_FLOOR)


def join(curve, costs):
    """The concatenated curve: a later phase's initial cost is the
    previous phase's best, so it is dropped."""
    return list(costs) if not curve else curve + list(costs[1:])


def main(out_dir=OUT_DIR, device="cuda", phase_iters=PHASE_ITERS,
         noise_knots=NOISE_KNOTS, **build_kw):
    """Run the phases; returns the concatenated curve, the phase bests
    and the median ms of a refit."""
    curve, bests, walls = [], [], []
    u = std = None
    for i, knots in enumerate(noise_knots):
        cem = build(noise_knots=knots, u_trj_init=u, initial_std=std, seed=i,
                    device=device, **build_kw)
        walls += iterate(cem, phase_iters)
        u, std = handoff(cem.u_trj_best.cpu().numpy(),
                         cem.std_trj.cpu().numpy())
        curve = join(curve, cem.cost_lst)
        bests.append(float(cem.cost_best))
        print(f"[phase {i + 1}: noise_knots={knots}] best "
              f"{cem.cost_best:.1f} final {cem.cost:.1f}", flush=True)
    save_cost_curve("quadrotor_cem_anneal", curve, out_dir)
    ms = median_ms(walls)
    print(f"anneal best overall: {min(curve)} ({ms:.1f} ms a refit after "
          f"the first)", flush=True)
    return {"curve": [float(c) for c in curve], "phase_bests": bests,
            "ms": ms}


if __name__ == "__main__":
    from .run_all import study_cli
    sys.exit(study_cli("quadrotor_cem_anneal"))
