"""Why the spin task's first_order best drifts: chain x JVP precision.

    python3 -m irs_mpc_torch.tools.probe_spin_first_order [--seeds 8]
        [--iterations 21] [--out DIR] [--cpu]

from the repository root, on a machine with an NVIDIA GPU and the CUDA
toolkit.  ``planar_hand_spin_first_order`` (``examples/planar_hand_spin.py``
at first_order, 21 descents) lands at 52.6-127.7 over seeds 0-7 in the
port on the card, where the JAX package's seeds stay within 51.9-54.2 on
the CPU.  Two differences between those runs could decide it:

* the chain of the line search: the port's card runs use K4, the JAX
  package's CPU runs its scan chain (the warm ``step_ws`` chain, which the
  port runs where ``ls_rollout_fn`` is None);
* the JVP of the contact QP: the port solves its KKT system in float64,
  the JAX package in float32 (``irs_mpc_tpu/models/contact/qp.py:143-161``).

For each seed the probe runs the four combinations from the same stream
(chain: ``k4`` or ``plain``; JVP: ``float64`` as the library does, or
``float32`` with the JAX algebra, patched in here for the run and restored
after, never an option of the library), and prints each cell's bests,
median and spread.  In the K4 cells every K4 call is also run through K4's
plain chain (``rollout.linesearch_rollout_plain``) on the same inputs, and
the largest gap is held against ``CHAIN_ATOL``: past it, K4 is at fault.
The results go to ``<out>/probe_spin_first_order.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time
from pathlib import Path

import torch

from ..examples import planar_hand_spin
from ..models.contact import cuda_rollout, qp, rollout
from ..utils.timing import card_line

CURVE, CHAIN_ATOL = "planar_hand_spin_first_order", 5e-3
CHAINS, JVPS = ("k4", "plain"), ("float64", "float32")


def _jvp_float32(ctx, dP, dq, dC, dd, _):
    """``qp._SolveQP.jvp`` in the inputs' float32, as the JAX package's
    ``_solve_qp_jvp`` computes it: D = min(lam / max(s, 1e-8), W_CAP),
    H = P + C'DC + 1e-10 I, rhs = -(dP x + dq + dC' lam) + C' D (dd - dC x),
    dx = solve_spd(H, rhs)."""
    P, C, x, s, lam = ctx.saved_tensors
    dP, dq = qp._zero_if_none(dP, P), qp._zero_if_none(dq, x)
    dC, dd = qp._zero_if_none(dC, C), qp._zero_if_none(dd, s)
    n = x.shape[-1]
    D = torch.clamp(lam / torch.clamp(s, min=1e-8), max=qp.W_CAP)
    Ct = C.transpose(-1, -2)
    H = P + (Ct * D.unsqueeze(-2)) @ C \
        + 1e-10 * torch.eye(n, dtype=x.dtype, device=x.device)
    rhs = -(qp._mv(dP, x) + dq + qp._mv(dC.transpose(-1, -2), lam)) \
        + qp._mv(Ct, D * (dd - qp._mv(dC, x)))
    return qp.solve_spd(H, rhs), None, None


@contextlib.contextmanager
def jvp_precision(kind):
    """The contact QP's JVP in ``kind`` while the context lasts."""
    saved = qp._SolveQP.jvp
    if kind == "float32":
        qp._SolveQP.jvp = staticmethod(_jvp_float32)
    try:
        yield
    finally:
        qp._SolveQP.jvp = saved


class ChainAudit:
    """A K4 ``ls_rollout_fn`` (the solver calls it without the model) that
    also runs the plain chain on every call's inputs and keeps the largest
    gap."""

    def __init__(self):
        self.model, self.gap, self.calls = None, 0.0, 0

    def __call__(self, *args):
        xs, us = cuda_rollout.linesearch_rollout_cuda(self.model, *args)
        xr, ur = rollout.linesearch_rollout_plain(self.model, *args)
        self.gap = max(self.gap, (xs - xr).abs().max().item(),
                       (us - ur).abs().max().item())
        self.calls += 1
        return xs, us


def best(seed, chain, jvp, iterations, device, audit=None):
    """The best of ``iterations`` descents of the spin task at first_order
    from ``seed``'s stream, on ``chain`` with the JVP in ``jvp``."""
    solver, model = planar_hand_spin.build_solver(
        gradient_mode="first_order", device=device)
    system = solver.system
    if chain == "plain":
        system = dataclasses.replace(system, ls_rollout_fn=None)
    elif audit is not None:
        audit.model = model
        system = dataclasses.replace(system, ls_rollout_fn=audit)
    solver = type(solver)(system, dataclasses.replace(solver.params,
                                                      seed=seed),
                          device=device)
    with jvp_precision(jvp):
        solver.iterate(iterations, verbose=False)
    return float(solver.cost_best)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=21)
    ap.add_argument("--out", type=Path,
                    default=Path(__file__).resolve().parents[1] / "_build")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU: the K4 cells then take the "
                         "plain chain too (no card numbers)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --cpu to run on the CPU)")
        print(card_line(), flush=True)
    cells, audits = {}, {}
    t0 = time.perf_counter()
    for chain in CHAINS:
        for jvp in JVPS:
            audit = ChainAudit() if chain == "k4" and device == "cuda" \
                else None
            bests = [best(seed, chain, jvp, args.iterations, device, audit)
                     for seed in range(args.seeds)]
            cells[f"{chain}/{jvp}"] = bests
            print(f"[{chain} chain, {jvp} JVP] bests "
                  + " ".join(f"{b:.4f}" for b in bests)
                  + f"; median {statistics.median(bests):.4f}, spread "
                  f"{min(bests):.4f}-{max(bests):.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if audit is not None:
                audits[f"{chain}/{jvp}"] = dict(calls=audit.calls,
                                                gap=audit.gap)
                print(f"  K4 against its plain chain over {audit.calls} "
                      f"calls: largest gap {audit.gap:.3e} "
                      f"(CHAIN_ATOL {CHAIN_ATOL})", flush=True)
    summary = {cell: dict(bests=b, median=statistics.median(b),
                          min=min(b), max=max(b))
               for cell, b in cells.items()}
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "probe_spin_first_order.json").write_text(json.dumps(
        dict(curve=CURVE, seeds=args.seeds, iterations=args.iterations,
             device=device, cells=summary, k4_audit=audits), indent=1))
    faults = [cell for cell, a in audits.items() if a["gap"] >= CHAIN_ATOL]
    if faults:
        print(f"K4 FAULT: its chain leaves its plain chain by >= "
              f"{CHAIN_ATOL} in {faults}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
