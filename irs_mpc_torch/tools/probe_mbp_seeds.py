"""The second-order (mbp2d) paths over seeds: the best cost after 10
iterations.

    python3 -m irs_mpc_torch.tools.probe_mbp_seeds [--seeds 8]
        [--device cuda] [--paths planar_hand_second_zero_order_B,...]

from the repository root.  For each path of ``chip_smoke.MBP_PATHS`` (by
default all five) and each seed it runs the path's solver, the JAX
package's example configuration, for 10 iterations from that seed's
random stream and prints its best cost, then each path's median over the
seeds beside the committed curve's value at 10.  ``python
tests/test_torch_mbp2d.py --jax-seeds 8`` prints the JAX package's on the
CPU.
"""
import argparse
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", default=",".join(p[0] for p in cs.MBP_PATHS))
    args = ap.parse_args()
    where = (cs.card_line() if args.device.startswith("cuda")
             else "the CPU")
    print(f"torch {torch.__version__}; {where}")
    wanted = args.paths.split(",")
    t0 = time.perf_counter()
    for label, builder, kw, _, csv, *_ in cs.MBP_PATHS:
        if label not in wanted:
            continue
        bests = []
        for seed in range(args.seeds):
            solver, _ = getattr(cs, builder)(args.device, seed=seed, **kw)
            solver.iterate(cs.MBP_ITERATIONS, verbose=False)
            bests.append(solver.cost_best)
            print(f"{label} seed {seed}: best {solver.cost_best:.4f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        curve = cs.csv_curve(csv)[cs.MBP_ITERATIONS]
        print(f"{label}: median best {statistics.median(bests):.4f} over "
              f"seeds 0-{args.seeds - 1}; committed curve at "
              f"{cs.MBP_ITERATIONS}: {curve:.4f}; sorted "
              + " ".join(f"{b:.3f}" for b in sorted(bests))
              + f" ({where})", flush=True)


if __name__ == "__main__":
    main()
