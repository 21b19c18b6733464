"""Example curves over seeds: the best cost at the driver's budget.

    python3 -m irs_mpc_torch.tools.probe_curve_seeds [--seeds 8]
        [--first-seed 0] [--device cuda] [--curves curve,...]

from the repository root.  For each curve of the curve runner's
``RERUNS`` (``irs_mpc_torch/examples/run_all.py``; by default all) and
each seed it runs the driver's solver from that seed's random stream at
the driver's iterations and prints its best; then each curve's median and
sorted bests beside the committed curve's best and, where the runner
holds the curve on a median, the rule's reference.  ``python
tests/test_torch_examples.py --jax-seeds 8 <curve>`` prints the JAX
package's on the CPU.
"""
import argparse
import statistics
import time

import torch

from ..examples.common import committed_curve
from ..examples.run_all import DEFAULT, RERUNS, RULES
from ..utils.timing import card_line


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--curves", default=",".join(RERUNS))
    args = ap.parse_args()
    where = (card_line() if args.device.startswith("cuda") else "the CPU")
    print(f"torch {torch.__version__}; {where}")
    t0 = time.perf_counter()
    for curve in args.curves.split(","):
        reference = RULES.get(curve, DEFAULT).reference
        bests = []
        seeds = range(args.first_seed, args.first_seed + args.seeds)
        for seed in seeds:
            bests.append(RERUNS[curve](seed, args.device))
            print(f"{curve} seed {seed}: best {bests[-1]:.4f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        print(f"{curve}: median best {statistics.median(bests):.4f} over "
              f"seeds {seeds[0]}-{seeds[-1]}; committed curve's best "
              f"{committed_curve(curve).min():.4f}; the rule's reference "
              f"{reference}; sorted "
              + " ".join(f"{b:.3f}" for b in sorted(bests))
              + f" ({where})", flush=True)


if __name__ == "__main__":
    main()
