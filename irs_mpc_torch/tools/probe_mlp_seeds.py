"""The learned-pendulum example over seeds: training loss and the plans'
cost on the true dynamics.

    python3 -m irs_mpc_torch.tools.probe_mlp_seeds [--seeds 8] [--device cuda]

from the repository root.  For each seed it runs ``learned_pendulum`` of
``irs_mpc_torch/examples/pendulum_nn.py`` (the JAX example's: an MLP
(64, 64) on 20k transitions for 600 Adam steps, then the exact and
zero-order swing-ups through it, T=100, 500 samples, 10 iterations) and
prints the last training loss, each mode's best cost on the learned model
and its plan's cost on the true pendulum; then the median of each over
the seeds.  The seed draws the transitions, the initial weights and the
minibatches, so these numbers spread with it; ``python
tests/test_torch_mlp.py --jax-seeds 8`` prints the JAX package's on the
CPU.
"""
import argparse
import statistics
import time

import torch

from ..examples.pendulum_nn import learned_pendulum
from ..utils.timing import card_line

COLUMNS = ("loss", "exact best", "exact true", "zero_order best",
           "zero_order true")


def seed_row(seed, device):
    """(loss, exact best, exact true, zero_order best, zero_order true)."""
    loss, out = learned_pendulum(device, seed=seed)
    row = [loss]
    for mode in ("exact", "zero_order"):
        solver, true_cost = out[mode]
        row += [solver.cost_best, true_cost]
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    where = (card_line() if args.device.startswith("cuda")
             else "the CPU")
    print(f"torch {torch.__version__}; {where}")
    rows = []
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        rows.append(seed_row(seed, args.device))
        print(f"seed {seed}: " + ", ".join(
            f"{c} {v:.6g}" for c, v in zip(COLUMNS, rows[-1]))
            + f" ({time.perf_counter() - t0:.0f} s)", flush=True)
    print("median over seeds: " + ", ".join(
        f"{c} {statistics.median(col):.6g}"
        for c, col in zip(COLUMNS, zip(*rows))) + f" ({where})")


if __name__ == "__main__":
    main()
