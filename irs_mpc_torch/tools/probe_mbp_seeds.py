"""The second-order (mbp2d) paths over seeds: the best cost after 10
iterations.

    python3 -m irs_mpc_torch.tools.probe_mbp_seeds [--seeds 8]
        [--device cuda] [--paths planar_hand_second_zero_order_B,...]

from the repository root.  For each path of ``PATHS`` (by default all
five, those of ``chip_smoke.py`` phase 18) and each seed it runs the
path's solver, the JAX package's example configuration, for 10
iterations from that seed's
random stream and prints its best cost, then each path's median over the
seeds beside the committed curve's value at 10.  ``python
tests/test_torch_mbp2d.py --jax-seeds 8`` prints the JAX package's on the
CPU.
"""
import argparse
import statistics
import time

import torch

from ..examples import box_pushing_second_order, planar_hand_second_order
from ..examples.common import committed_curve
from ..utils.timing import card_line

ITERATIONS = 10
# label: (builder, its keyword arguments, the committed curve)
PATHS = {
    "planar_hand_second_exact": (planar_hand_second_order.build_solver,
                                 dict(gradient_mode="exact"),
                                 "planar_hand_second_exact"),
    "planar_hand_second_first_order": (
        planar_hand_second_order.build_solver,
        dict(gradient_mode="first_order"), "planar_hand_second_first_order"),
    "planar_hand_second_zero_order_B": (
        planar_hand_second_order.build_solver,
        dict(gradient_mode="zero_order_B"),
        "planar_hand_second_zero_order_B"),
    "planar_hand_second_torque": (planar_hand_second_order.build_solver,
                                  dict(control_mode="torque"),
                                  "planar_hand_second_torque"),
    "box_pushing_second_order": (box_pushing_second_order.build_solver, {},
                                 "box_pushing_second_order_position"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    where = (card_line() if args.device.startswith("cuda")
             else "the CPU")
    print(f"torch {torch.__version__}; {where}")
    wanted = args.paths.split(",")
    t0 = time.perf_counter()
    for label in wanted:
        builder, kw, csv = PATHS[label]
        bests = []
        for seed in range(args.seeds):
            solver, _ = builder(seed=seed, device=args.device, **kw)
            solver.iterate(ITERATIONS, verbose=False)
            bests.append(solver.cost_best)
            print(f"{label} seed {seed}: best {solver.cost_best:.4f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        curve = committed_curve(csv)[ITERATIONS]
        print(f"{label}: median best {statistics.median(bests):.4f} over "
              f"seeds 0-{args.seeds - 1}; committed curve at "
              f"{ITERATIONS}: {curve:.4f}; sorted "
              + " ".join(f"{b:.3f}" for b in sorted(bests))
              + f" ({where})", flush=True)


if __name__ == "__main__":
    main()
