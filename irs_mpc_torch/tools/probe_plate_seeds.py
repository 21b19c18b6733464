"""Plate pickup's 8-descent best over seeds, with K2 and with the plain PDIP.

    python3 -m irs_mpc_torch.tools.probe_plate_seeds [--seeds 32]

from the repository root, on a machine with an NVIDIA GPU and the CUDA
toolkit.  For each seed it runs the plate-pickup solver of
``irs_mpc_torch/examples/plate_pickup.py`` for 8 iterations on the card
twice from the same stream: once as built, the estimation's contact QPs on
K2, and once with every K2 call replaced by the plain PDIP on the same
tensors.  It prints each seed's best for both, then for each route the
median best and the number of seeds within 12 % of the golden 3.216
(``tests/test_golden_contact.py:38``), and in how many seeds K2's best was
the lower.  Everything but the QP solver is the same in both runs, so the
two distributions differ only by K2's rounding against the plain PDIP's.
"""
import argparse
import statistics
import time

import torch

from ..examples import plate_pickup
from ..models.contact import cuda_qp, cuda_rollout
from ..ops import _nvcc, cuda_admm, cuda_riccati
from ..utils import timing
from ..utils.timing import card_line

ITERATIONS, INITIAL, BEST, RTOL = (
    plate_pickup.GOLDEN_ITERATIONS, plate_pickup.GOLDEN_INITIAL,
    plate_pickup.GOLDEN_BEST, plate_pickup.GOLDEN_RTOL)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def plain_on_card(P, q, C, d, iters=30, sigma=0.25, init=None,
                  want_lam=False):
    return cuda_qp.solve_qp_batched_plain(P, q, C, d, iters, sigma, init,
                                          want_lam)


def best(seed, route):
    """The 8-descent best of plate pickup from ``seed`` with K2
    (``route="K2"``) or the plain PDIP."""
    real = cuda_qp.solve_qp_batched_cuda
    if route == "plain":
        cuda_qp.solve_qp_batched_cuda = plain_on_card
    try:
        solver, _ = plate_pickup.build_solver(seed=seed, device="cuda")
        cuda_qp.LAUNCHES = 0
        timing.reset()
        with timing.tracing():
            solver.iterate(ITERATIONS, verbose=False)
        torch.cuda.synchronize()
    finally:
        cuda_qp.solve_qp_batched_cuda = real
    sweeps = timing.counted("estimation")
    timing.reset()
    launches = cuda_qp.LAUNCHES
    # Two K2 solves an estimation: the host launches them where it runs
    # eagerly and in its graph's warm-up, and a replay runs the captured.
    eager = ITERATIONS - sweeps["est_graph"] + sweeps["est_capture"]
    want = 2 * eager if route == "K2" else 0
    check(launches == want, f"seed {seed} {route}: {launches} K2 "
                            f"launches, expected {want}")
    check(abs(solver.cost_lst[0] - INITIAL) <= 1e-3 * INITIAL,
          f"seed {seed} {route}: initial cost {solver.cost_lst[0]}")
    return solver.cost_best


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=32)
    args = ap.parse_args()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = card_line()
    print(f"torch {torch.__version__}; {card}")
    _nvcc.build_all([mod.LIB for mod in (cuda_riccati, cuda_qp, cuda_admm,
                                         cuda_rollout)])
    bests = {"K2": [], "plain": []}
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        for route in bests:
            bests[route].append(best(seed, route))
        print(f"seed {seed}: K2 {bests['K2'][-1]:.4f} plain "
              f"{bests['plain'][-1]:.4f} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    lo, hi = (1 - RTOL) * BEST, (1 + RTOL) * BEST
    for route, b in bests.items():
        inside = sum(lo <= x <= hi for x in b)
        print(f"{route}: median {statistics.median(b):.4f}; within 12 % of "
              f"{BEST}: {inside} of {len(b)}; seeds 0-15 median "
              f"{statistics.median(b[:16]):.4f}; sorted "
              + " ".join(f"{x:.3f}" for x in sorted(b)))
    lower = sum(k < p for k, p in zip(bests["K2"], bests["plain"]))
    print(f"K2's best the lower in {lower} of {args.seeds} seeds ({card})")


if __name__ == "__main__":
    main()
