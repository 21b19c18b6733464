"""A three-iteration descent with the estimation sharded across ranks.

The port of the JAX package's ``__graft_entry__.dryrun_multichip``: over a
(sample, knot) ``Mesh`` of every rank of the ``torch.distributed`` group
(8 cells in all, as the JAX package's 8 devices, split evenly over the
ranks, each rank's on its own device; two knot shards), the pendulum (T=16, 8
samples a cell, zero-order) and then the planar-hand contact engine (T=8,
2 samples a cell, zero_order_B, boxed ADMM at 8 sweeps) each descend three
iterations.  Every cost must be finite and the best-so-far cost never rise
(rtol 1e-6: the alpha = 0 lane of the line search keeps an accepted
iterate from regressing past the nominal); the pendulum must make
progress, and the trajectories keep their shapes.

    python -m irs_mpc_torch.examples.dryrun [--ranks N] [--cpu]

starts N processes (default 1; N divides 8), one device each (``cuda:rank``, or the
CPU with ``--cpu`` over gloo), joined through a ``file://`` rendezvous in
a temporary directory; each runs ``dryrun`` and the exit code is 0 only if
every rank passed.  Inside a group the caller made, call ``dryrun(device)``
directly.
"""
from __future__ import annotations

import argparse
import multiprocessing
import queue as queue_mod
import sys
import time
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import IrsMpc, SmoothingConfig, make_pendulum
from ..parallel import multihost
from . import pendulum, planar_hand

# The JAX package's dry run runs on 8 devices (tests/test_graft_entry.py,
# MULTICHIP_r05.json); at fewer cells the planar hand's 2 samples a cell
# let the best-so-far cost rise in both packages (the JAX package on one
# CPU device: 225.31 -> 250.50), so the port lays 8 cells over its ranks.
ITERATIONS, RTOL, CELLS = 3, 1e-6, 8


class DryRunFailure(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise DryRunFailure(msg)


def descend(solver, label, iterations=ITERATIONS):
    """``iterations`` descents; returns the costs after checking that each
    is finite and that none rises past the best so far."""
    solver.iterate(iterations, verbose=False)
    costs = [float(c) for c in solver.cost_lst]
    _check(all(np.isfinite(c) for c in costs),
           f"{label}: non-finite cost in {costs}")
    best = costs[0]
    for c in costs[1:]:
        _check(c <= best * (1 + RTOL),
               f"{label}: iterate cost {c} regressed past the best {best} "
               f"(the alpha = 0 lane must prevent this)")
        best = min(best, c)
    print(f"dryrun({CELLS} cells): mesh={solver.params.mesh.shape} {label} "
          f"costs=" + "->".join(f"{c:.3f}" for c in costs) + " OK",
          flush=True)
    return costs


def dryrun(device="cuda"):
    """The dry run with CELLS // world cells of the mesh on this rank's
    ``device``, over the group's mesh (this process alone outside a
    group), so the mesh always has the JAX run's CELLS cells.  Returns the
    two cost curves."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if CELLS % world:
        raise ValueError(f"the dry run lays its {CELLS} cells evenly over "
                         f"the ranks; {world} ranks do not divide them")
    mesh = multihost.pod_mesh(knot_shards=2,
                              local_devices=[device] * (CELLS // world))
    pend = IrsMpc(make_pendulum(0.05), pendulum.build_params(
        "zero_order", T=16, num_samples=8 * CELLS, mesh=mesh), device=device)
    costs = descend(pend, "pendulum")
    _check(costs[-1] < costs[0], "pendulum: the 3-iteration descent made "
                                 "no progress")
    _check(tuple(pend.x_trj.shape) == (17, 2)
           and tuple(pend.u_trj.shape) == (16, 1),
           f"pendulum shapes {tuple(pend.x_trj.shape)}, "
           f"{tuple(pend.u_trj.shape)}")
    hand, _ = planar_hand.build_solver(
        T=8, device=device, mesh=mesh, admm_iters=8, admm_over_relax=1.0,
        estimation_system=None,
        smoothing=SmoothingConfig(num_samples=2 * CELLS, std_u=0.3,
                                  std_x=1e-3))
    hand_costs = descend(hand, "planar-hand contact")
    _check(tuple(hand.x_trj.shape) == (9, 7)
           and tuple(hand.u_trj.shape) == (8, 4),
           f"planar-hand shapes {tuple(hand.x_trj.shape)}, "
           f"{tuple(hand.u_trj.shape)}")
    return costs, hand_costs


def _rank(rank, world, init, cpu, queue):
    device = "cpu" if cpu else f"cuda:{rank}"
    multihost.initialize(init, world_size=world, rank=rank,
                         backend="gloo" if cpu else "nccl")
    try:
        queue.put((rank, dryrun(device)))
    finally:
        dist.destroy_process_group()


def run(ranks=1, cpu=False, timeout=600):
    """Run the dry run in ``ranks`` processes; returns each rank's curves
    and raises if a rank failed."""
    if CELLS % ranks:
        raise ValueError(f"{ranks} ranks do not divide the {CELLS} cells")
    if not cpu and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} CUDA devices; "
                           f"{torch.cuda.device_count()} found")
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_rank, args=(r, ranks, init, cpu, queue))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout
        try:
            while len(results) < ranks:
                try:
                    rank, curves = queue.get(timeout=1.0)
                    results[rank] = curves
                except queue_mod.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break                   # a rank failed
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"dry run: no result in "
                                           f"{timeout} s")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if len(results) < ranks or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dry run: exit codes {[p.exitcode for p in procs]}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo over the CPU instead of NCCL over the cards")
    args = ap.parse_args()
    results = run(args.ranks, args.cpu)
    same = all(results[r] == results[0] for r in results)
    print(f"dryrun over {args.ranks} rank(s): every rank passed; the ranks' "
          f"curves {'agree' if same else 'DIFFER'}")
    sys.exit(0 if same else 1)
