#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``irs_mpc_torch``) on one GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which passes or ends the run with a non-zero
exit code:

0. environment: torch, CUDA, nvcc and the card; fails without a CUDA device;
1. builds the four kernels from ``irs_mpc_torch/csrc/`` (one nvcc each, all
   started together): K1 Riccati, K2 batched PDIP, K3 boxed ADMM, K4 the
   contact line-search chain;
2. holds K1 with its linear plan (``lqr_solve`` in one launch) against the
   plain PyTorch loop and plan on the card at four problems (pendulum
   T=200 n=2 m=1; a T=200 n=16 m=4 random problem, its knots streamed; a
   Δu problem with a cross term; a Δu problem at n = 20 on the wide
   block) and times both;
3. drives the pendulum iRS-MPC slice (T=200, 1000 samples per knot,
   zero-order, 9 iterations) on the card and holds it to the reference
   cost curve: initial 1856.1541, final and best <= 360, one K1 launch per
   iteration;
4. holds K2 against the plain batched PDIP, solutions and duals, on the
   two solves of the planar-hand slice's first iteration (30 QPs at 30
   iterations, 1500 at 15) and on 2048 planar-hand contact QPs (cold at 30
   iterations, also against a converged 120-iteration solve, and a warm
   start from the duals), and times both at the slice's shapes;
5. holds K3 against the plain factored ADMM loop on the trajectory QP of
   the planar-hand slice's first iteration, on five bound-kind
   combinations of a seeded Δu problem and on wide problems in both
   placements of the knots' operands (n = 50 and 64 with m = 16 in shared
   memory, and T = 200, n = 16, m = 4 streamed), and K1 with its plan
   against the plain loop on that first-iteration problem (the ADMM's
   initial solve), and times both;
6. holds K4 against the plain lane-batched chain on the line search of the
   slice's first iteration (6 lanes, T=30), and times both;
7. drives the planar-hand iRS-MPC slice (T=30, 50 samples per knot,
   zero_order_B, boxed ADMM, 8 iterations) on the card: initial cost
   325.0136 within 0.1%, best within 12% of 22.26, and per iteration
   exactly 2 launches of K2 and 1 each of K1, K3 and K4;
8. holds K2 (both calls), K3, K1 and K4 against their plain versions on
   what the first iteration of each box slice hands them (box pushing:
   60 + 6000 QPs of 5 unknowns and 2 rows, T=60 n=7 m=2 with a du box,
   6 lanes x 60 knots with relative input bounds; box pivoting: 40 + 4000
   QPs with 18 rows, T=40 with a u box, 6 lanes x 40 knots with
   canonicalised duals), and times both;
9. holds K4 against its plain chain on every pair kind in both orders:
   the three slices' first-iteration line searches with every pair's sides
   swapped, and built inputs for plate pickup (capsule-box on prismatic
   fingers) and a circle-circle model, both ways round;
10. drives the box-pushing slice (T=60, 100 samples per knot, relative
   input bounds, 8 iterations): initial cost 134.4132 within 0.1%, best
   within 12% of 46.16, the same launches per iteration as the hand;
11. drives the box-pivoting slice (T=40, 100 samples per knot,
   canonicalised duals, 8 iterations): initial cost 786.3928 within 0.1%,
   best at most 12% above 317.41, the same launches; then the same solver
   without its whole-chain rollout (the per-knot warm chain), for its curve;
12. profiles a box-pushing iteration: each phase synchronised and timed
   on the host's clock, then the device's busy share and kernels in one
   ``utils.timing.profile_trace`` session, whose Chrome trace
   (``irs_mpc_torch/_build/trace/``) must name K4's kernel and hold the
   program's own ``irs/`` spans, reported by ``utils.timing.report``;
13. holds K3 and K1 against their plain versions on the trajectory QP of
   the carrots slice's first iteration (T=10, n=45+5, m=5, u box, 20
   sweeps), then drives the carrots slice (45 dof, 500 contact rows, 30
   samples per knot, 3 iterations): initial cost 211.8252 within 0.1%,
   best within 12% of 172.98, per iteration exactly 1 launch each of K1
   and K3 and none of K2 and K4 (the model is past their limits; its
   contact solves run as plain PyTorch on the card);
14. the CEM baseline: K4 against its plain chain on the first population
   of the planar-hand CEM (2000 open-loop lanes, T=30) and of the
   box-pushing one (100 x 60), then the CEM configurations of the JAX
   package's examples (planar hand 40 iterations, box pushing 15, pendulum
   150, bicycle to the hard goal 25, box pivoting 20), each with its
   initial cost within 0.1 % and its best at most 1.12 x its committed
   curve's last value (box pivoting: below its initial cost), and exactly
   2 K4 launches an iteration where the model has a whole-chain rollout
   (the planar hand, box pushing) and none otherwise;
15. ``forward_mode="resolve"``: K3 and K1 against their plain versions on
   the masked problem of the planar hand's first resolve iteration at knot
   15 and of the pendulum's (T=50, n=2, m=1) at knot 25, then the pendulum with a binding input box (T=50, 5 iterations,
   |u| within the box, best within 20 % of the feedback mode's after 8),
   T launches each of K1 and K3 an iteration; then the planar hand, 2
   iterations (2 K2, 30 K1, 30 K3, no K4 an iteration);
16. plate pickup (T=30, 100 samples a knot, relative input bounds, 30
   sweeps): K2 (both calls), K3 and K1 on its first iteration, then 8
   iterations for each of sixteen seeds, 2 K2 and 1 each of K1 and K3 an
   iteration and no K4 (``chain_gate``), the median best within 12 % of
   3.216; then one first_order iteration, whose nominal step goes through
   the estimation surrogate's batched step (1 K2);
17. K1 against its plain version on the quadrotor's first-iteration
   problem (T=200, n=12, m=4), K3 and K1 on the three carts' (T=100, n=6,
   m=2, u box); then the quadrotor (T=200, 1000 samples, 7 iterations)
   and the three carts (T=100, 1000 samples with projection, 20
   iterations) iRS examples:
   initial costs within 0.1 %, best within 12 % of their committed curves'
   minima, 1 K1 an iteration (and 1 K3 for the carts' input box);
18. the second-order (mbp2d) paths of the JAX package's examples, 10
   iterations each: the planar hand in position mode (exact, first_order,
   zero_order_B), its torque spin (seeds 0-5, held on their median) and
   box pushing, exactly 1 K1 and 1 K3 an iteration and no K2 or K4, held
   to the committed curves; K3 and K1 against their plain versions at the
   three shapes (Δu n = 18, torque n = 14, box pushing n = 12);
19. the second-order CEM (16000 x T=30, 50 iterations), no kernel;
20. the associative-scan Riccati pass against K1 and the plain pass at
   three shapes, and the pendulum with ``parallel_riccati`` (no K1 or K3
   launch) within 1e-3 of the K1 path's cost;
21. ``examples/pendulum_nn.py``: the MLP trained on the card, exact and
   zero-order swing-ups through it (1 K1 an iteration), seeds 0-7, their
   medians held to the JAX package's;
22. a one-rank NCCL group: the five modes' estimates on a 2 x 2 mesh of
   the card against single-device ones, and the pendulum on the mesh;
23. box pushing on the LCP contact model: K2 against the plain PDIP on the
   two calls of its first zero_order_AB iteration (rows of separated
   pairs masked to 0 dq <= 1), then that curve at its 21 descents under
   the curve runner's rule (``irs_mpc_torch/examples/run_all.py``), 2 K2,
   1 K1, 1 K3 and no K4 an iteration; the pendulum slice checkpointed
   after 2 iterations and resumed for 3, equal bit for bit to 5 straight;
   ``utils.config.make_system("box_pushing", 0.1, contact_model="lcp")``
   on the card: no reaction at an open gap;
24. the closing slice: K2, K3, K1 and K4 against their plain versions on
   the first iteration of the long-arm model (a six-link arm and a
   two-link arm around a ball, ``long_arm_model``: K4's link table) and
   K4 on built inputs with its pairs' sides swapped, then its solver (T=20,
   50 samples, 4 iterations: 2 K2 and 1 each of K1, K3 and K4 an
   iteration, initial cost 32.5087 within 0.1 %, best below it); the
   bundle study's deterministic parts (``examples/bundle_study.py``: the
   exact slope, the 101-point sweep, both contact models' 81-point true
   curves) within 1e-5 of the JAX study's on the CPU; the estimator
   comparison (``examples/planar_hand_second_order_estimators.py``), each
   mode's B within 0.02 of the exact one relative to its largest entry;
   the multi-rank dry run (``examples/dryrun.py``) on one NCCL rank.

The example configurations are built by ``irs_mpc_torch/examples/``; this
script keeps its names for them (``planar_hand_solver`` and so on, the
device first).

Each phase prints its wall seconds.  K1's rows time it with the plan, as
every path calls it (``lqr_solve``); K2's name the lanes of its tile a
QP.  Every kernel's time stands beside its bound, the larger of its
operations over the card's float32 peak and its bytes over its memory
rate.  The last
lines are a JSON summary of the kernels, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""
import collections
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from irs_mpc_torch import (IrsMpc, IrsMpcParams, SmoothingConfig,
                           make_box_pivoting, make_box_pushing, make_pendulum,
                           make_planar_hand, make_plate_pickup,
                           make_quadrotor, make_three_cart)
from irs_mpc_torch.examples import (bicycle, box_pivoting, box_pushing,
                                    box_pushing_cem as box_pushing_cem_ex,
                                    box_pushing_second_order, carrots,
                                    common, pendulum, pendulum_nn,
                                    planar_hand,
                                    planar_hand_cem as planar_hand_cem_ex,
                                    planar_hand_second_order, plate_pickup,
                                    quadrotor, three_cart)
from irs_mpc_torch.models.contact import (cuda_qp, cuda_rollout, geometry,
                                          quasistatic, rollout)
from irs_mpc_torch.ops import _nvcc, admm, cuda_admm, cuda_riccati, lqr
from irs_mpc_torch.tools import kernel_inputs
from irs_mpc_torch.tools.kernel_inputs import bench_problem, capture
from irs_mpc_torch.utils import timing
from irs_mpc_torch.utils.timing import (block_until_ready, card_line,
                                        profile_trace)

REL_TOL = 1e-3          # max|ΔK| / max|K|, the same for k, x and u
INITIAL_COST = 1856.1541
INITIAL_TOL = 0.01
FINAL_COST_MAX = 360.0
T, NUM_SAMPLES, ITERATIONS = 200, 1000, 9

# The planar-hand slice and its goldens (tests/test_golden_contact.py).
HAND_T, HAND_S, HAND_ITERATIONS = 30, 50, 8
HAND_INITIAL = 325.0136
HAND_BEST, HAND_BEST_RTOL = 22.26, 0.12
# The box slices and their goldens (tests/test_golden_contact.py).  The
# best of box_pivoting is gated from above only: on that stiff model the
# JAX package's kernel chain and its scan chain settle in different basins
# (186.8 against 228.6 at 10 descents), and 317.41 is the scan chain's.
BOX_S, BOX_ITERATIONS, BOX_BEST_RTOL = 100, 8, 0.12
BOX_PUSHING_T, BOX_PUSHING_INITIAL, BOX_PUSHING_BEST = 60, 134.4132, 46.16
BOX_PIVOTING_T, BOX_PIVOTING_INITIAL, BOX_PIVOTING_BEST = 40, 786.3928, 317.41
# Carrots at its golden's 3 descents (tests/test_golden_contact.py:65-73).
CARROTS_T, CARROTS_S, CARROTS_ITERATIONS = 10, 30, 3
CARROTS_INITIAL, CARROTS_BEST = 211.8252, 172.98
# Plate pickup at its golden's 8 descents (tests/test_golden_contact.py:38),
# held on the median best over seeds 0-15 of the solver's own stream
# (``examples/plate_pickup.py``'s GOLDEN_*: its best depends on the stream;
# 3.5258 with K2, 3.5229 plain, a 2 % margin to the bound; about 140 s of
# the smoke).
PLATE_T, PLATE_S = 30, 100
PLATE_ITERATIONS, PLATE_INITIAL, PLATE_BEST, PLATE_SEEDS = (
    plate_pickup.GOLDEN_ITERATIONS, plate_pickup.GOLDEN_INITIAL,
    plate_pickup.GOLDEN_BEST, plate_pickup.GOLDEN_SEEDS)
# Resolve mode (tests/test_irs_mpc.py:137-154): the pendulum with a binding
# input box, held within 20 % of the feedback mode's best after 8
# iterations; then the planar hand, 2 iterations.
RESOLVE_T, RESOLVE_ITERATIONS, RESOLVE_FEEDBACK_ITERATIONS = 50, 5, 8
RESOLVE_U_MAX, RESOLVE_BEST_RTOL, HAND_RESOLVE_ITERATIONS = 2.0, 0.2, 2
# The analytic models' iRS examples, held to their committed curves'
# minima within 12 % (examples/analysis/*_zero_order.csv).
QUAD_T, QUAD_S, QUAD_ITERATIONS, QUAD_INITIAL = 200, 1000, 7, 178342.25
CART_T, CART_S, CART_ITERATIONS, CART_INITIAL = 100, 1000, 20, 631.3722
# The CEM baseline on the card: (label, builder, iterations, the initial
# cost in float32, the committed curve, K4 launches an iteration, whether
# the best is held one-sided to 1.12 x the curve's last value).  The
# initial costs are what both packages compute in float32 on the CPU
# (tests/test_torch_cem.py); the curves were recorded on a TPU, where the
# JAX package's CEM rolls and costs its initial trajectory at the default
# matmul precision, and their first values lie within 0.1 % of these but
# for the planar hand's (325.5162, 0.15 % above).  Box pivoting's CEM model
# keeps its warm duals uncanonicalised, so ``chain_gate`` (stiff actuation,
# Kp = 5e4) keeps K4 off it, as the JAX package's gate does, and its search
# is basin-chaotic across program versions (examples/box_pivoting.py:93-100):
# its best is held only below its initial cost.
CEM_CASES = (
    ("planar_hand_cem", "planar_hand_cem", 40, 325.0136, "planar_hand_cem",
     2, True),
    ("box_pushing_cem", "box_pushing_cem", 15, 134.4132, "box_pushing_cem",
     2, True),
    ("pendulum_cem", "pendulum_cem", 150, 1856.1544, "pendulum_cem", 0, True),
    ("bicycle_hard_cem", "bicycle_cem", 25, 13301.09, "bicycle_hard_cem", 0,
     True),
    ("box_pivoting_cem", "box_pivoting_cem", 20, 786.3928, "box_pivoting_cem",
     0, False),
)
CEM_BEST_RTOL, CEM_INITIAL_RTOL = 0.12, 1e-3
# K3 and K4 against their plain versions: x, u, K at rtol/atol 1e-3 and
# the residuals at rtol 1e-2 (the JAX package's whole-loop ADMM check);
# the chain's xs, us at atol 5e-3 (its whole-chain rollout check).
ADMM_TOL, ADMM_RES_RTOL, CHAIN_ATOL = 1e-3, 1e-2, 5e-3
# K2 against the plain PDIP on the same QPs, x and the duals each as
# max|kernel - plain| / max|plain|: cold solves (the main path's two
# calls, the 2048-QP check) and a warm start from the duals, which
# amplifies the gap about tenfold.
QP_REL_TOL, QP_WARM_REL_TOL = 1e-5, 1e-4
# The second-order (mbp2d) paths, 10 iterations each (phase 18).  Initial
# costs: the float32 values both packages compute on the CPU
# (``tests/test_torch_mbp2d.py::test_smoke_configuration_is_the_example``,
# and ``tests/test_torch_cem.py`` for the CEM's; the committed curves'
# first values were recorded on a TPU, the torque spin's 812.4030 there,
# the CEM's 124.0655).  Bests against the committed
# curves at 10 iterations: exact and first_order within 12 %; the
# basin-chaotic paths (the JAX package's ``mbp2d.py:182-191``) one-sided,
# at most 1.12 x the curve.  The torque spin's best is decided by the
# stream in both packages (PERF.md §6: the JAX package's seeds 0-23 on
# the CPU land 47.8-125.8, median 69.9292, from ``python
# tests/test_torch_mbp2d.py --jax-seeds 24 planar_hand_second_torque``),
# so its median over seeds 0-5 (six, to keep phases 18-22 inside their
# 240 s on a slower host) is held at most 1.12 x that median.
# (label, builder, its keyword arguments, the float32 initial cost, the
# curve, two-sided, seeds, the reference best: None for the curve at 10.)
# K3 and K1 take their rows at each shape from the first iteration; box
# pushing's zero_order_AB fit there has A of spectral radius ~81, and
# float32 determines neither version's solution (PERF.md §6), so its
# rows come from the same configuration's first exact-mode iteration, and
# the zero_order_AB instance is printed against float64, not gated.
MBP_ROWS_FROM = {"box_pushing_second_order": dict(gradient_mode="exact")}
MBP_ITERATIONS, MBP_BEST_RTOL = 10, 0.12
MBP_PATHS = (
    ("planar_hand_second_exact", "planar_hand_second_solver",
     dict(gradient_mode="exact"), 118.8329, "planar_hand_second_exact",
     True, 1, None),
    ("planar_hand_second_first_order", "planar_hand_second_solver",
     dict(gradient_mode="first_order"), 118.8329,
     "planar_hand_second_first_order", True, 1, None),
    ("planar_hand_second_zero_order_B", "planar_hand_second_solver",
     dict(gradient_mode="zero_order_B"), 118.8329,
     "planar_hand_second_zero_order_B", False, 1, None),
    ("planar_hand_second_torque", "planar_hand_second_solver",
     dict(control_mode="torque"), 812.3893, "planar_hand_second_torque",
     False, len(planar_hand_second_order.TORQUE_SEEDS),
     planar_hand_second_order.TORQUE_JAX_MEDIAN),
    ("box_pushing_second_order", "box_pushing_second_solver", {}, 287.9763,
     "box_pushing_second_order_position", False, 1, None),
)
# The second-order CEM (phase 19): 16000 x T=30, 50 iterations, its best
# at most 1.12 x the committed curve at 50.
MBP_CEM_ITERATIONS, MBP_CEM_INITIAL = 50, 123.7646
# The associative scan (phase 20): K, k and P relative to the largest plain
# value, at the JAX package's assoc tolerances (``tests/test_lqr.py:94-119``:
# 5e-3 tracking, 1e-2 Δu); the pendulum's parallel_riccati cost within 1e-3
# of the K1 path's after 4 iterations (``tests/test_irs_mpc.py:40-46``).
ASSOC_TOL = {"tracking": 5e-3, "delta_u": 1e-2}
ASSOC_ITERATIONS, ASSOC_COST_RTOL = 4, 1e-3
# Learned dynamics (phase 21): ``examples/pendulum_nn.py`` over seeds 0-7.
# The seed draws the transitions, the initial weights and the minibatches,
# and the numbers spread with it (PERF.md §6), so the medians over the
# seeds are held at most 1.25 x the JAX package's medians over the same
# seeds on the CPU, from ``python tests/test_torch_mlp.py --jax-seeds 8``:
# training loss 2.09999e-4, the exact plan on the true pendulum 804.794,
# the zero-order plan 664.962.
MLP_SEEDS, MLP_RATIO = tuple(range(8)), 1.25
MLP_JAX_MEDIANS = {"loss": 2.09999e-4, "exact": 804.794,
                   "zero_order": 664.962}
# Sharding (phase 22): sharded against single-device estimates, A and B
# within 1e-4 of their largest entry and c of the largest of A x and B u
# (the same draws; the order of summation differs); the pendulum solver
# on a 2 x 2 mesh within 5 % of the single-device run
# (``tests/test_parallel.py:67-85``).
SHARD_REL_TOL, SHARD_COST_RTOL, SHARD_ITERATIONS = 1e-4, 0.05, 8
# The long-arm model (phase 24): K4 on a six-link arm, then its solver at
# T=20, 50 samples a knot, 4 iterations, 2 K2 and 1 each of K1, K3 and K4
# an iteration; its float32 initial cost on the CPU
# (tests/test_torch_arm_links.py).
LONG_ARM_T, LONG_ARM_S, LONG_ARM_ITERATIONS = 20, 50, 4
LONG_ARM_INITIAL = 32.5087
# One H100 SXM at its full 700 W (NVIDIA's data sheet): float32 outside the
# tensor cores, and the HBM3's rate.
F32_PEAK, HBM_RATE = 67e12, 3.35e12
KERNELS = (cuda_riccati, cuda_qp, cuda_admm, cuda_rollout)
DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pendulum_problems():
    """The tracking and Δu problems the pendulum slice hands the Riccati
    pass, from the exact linearisation along its initial rollout."""
    dev = DEVICE
    system = make_pendulum(0.05)
    u = torch.full((T, 1), 0.1, device=dev)
    x = system.rollout(torch.zeros(2, device=dev), u)
    AB = system.jacobian_xu_batch(x[:-1], u)
    A, B = AB[:, :, :2].contiguous(), AB[:, :, 2:].contiguous()
    c = system.step_batch(x[:-1], u) - torch.einsum("tij,tj->ti", A, x[:-1]) \
        - torch.einsum("tij,tj->ti", B, u)
    Q = torch.diag(torch.tensor([1., 1.], device=dev))
    Qd = torch.diag(torch.tensor([20., 20.], device=dev))
    R = torch.eye(1, device=dev)
    xd = torch.tensor([np.pi, 0.], dtype=torch.float32,
                      device=dev).expand(T + 1, 2)
    args = (A, B, c, Q, Qd, R, x[0], xd)
    return (lqr.build_tracking_problem(*args),
            lqr.build_delta_u_problem(*args, torch.tensor([0], device=dev)))


# ---------------------------------------------------------------------------
# The example configurations (irs_mpc_torch/examples/), called as the phases
# and the tests call them: the device first, then keywords
# ---------------------------------------------------------------------------

def _device_first(build, **defaults):
    def builder(device, **kw):
        return build(device=device, **dict(defaults, **kw))
    builder.__doc__ = build.__doc__
    return builder


planar_hand_solver = _device_first(planar_hand.build_solver)
box_pushing_solver = _device_first(box_pushing.build_solver)
box_pivoting_solver = _device_first(box_pivoting.build_solver)
carrots_solver = _device_first(carrots.build_solver)
plate_pickup_solver = _device_first(plate_pickup.build_solver)
planar_hand_second_solver = _device_first(
    planar_hand_second_order.build_solver)
planar_hand_second_cem = _device_first(
    planar_hand_second_order.build_cem_solver)
box_pushing_second_solver = _device_first(
    box_pushing_second_order.build_solver)
planar_hand_cem = _device_first(planar_hand_cem_ex.build_solver)
box_pushing_cem = _device_first(box_pushing_cem_ex.build_solver)
box_pivoting_cem = _device_first(box_pivoting.build_cem_solver)
pendulum_cem = _device_first(pendulum.build_cem_solver)
bicycle_cem = _device_first(bicycle.build_cem_solver, hard=True)
pendulum_params = pendulum.build_params
pendulum_nn_params = pendulum_nn.build_params
learned_pendulum = pendulum_nn.learned_pendulum
HAND_Q0 = planar_hand.Q0


def quadrotor_solver(device, T=QUAD_T, num_samples=QUAD_S):
    """``examples/quadrotor.py:27-44``, zero-order."""
    return IrsMpc(make_quadrotor(0.05), quadrotor.build_params(
        "zero_order", T, num_samples), device=device)


def three_cart_solver(device, T=CART_T, num_samples=CART_S):
    """``examples/three_cart.py:19-38``."""
    return IrsMpc(make_three_cart(0.05), three_cart.build_params(
        T, num_samples), device=device)


def first_iteration_inputs(solver_fn=planar_hand_solver, rollouts=1):
    """``kernel_inputs.first_iteration_inputs``, the planar hand's by
    default."""
    return kernel_inputs.first_iteration_inputs(solver_fn, rollouts, DEVICE)


def pendulum_resolve_params(forward_mode, T=RESOLVE_T):
    """The pendulum with a binding input box of +-2 in exact mode and 40
    ADMM sweeps (``tests/test_irs_mpc.py:137-154``)."""
    return IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)),
        u_bounds_abs=np.array([[-2.0], [2.0]]), gradient_mode="exact",
        admm_iters=40, forward_mode=forward_mode)


def circle_pair_model(geom, quasistatic):
    """A small model for the circle-circle pair kind, which no bundled
    model within K4's limits has: a round pusher (y, z) and a free ball
    (y, z, th) on the ground beside a round post.  ``geom`` and
    ``quasistatic`` are either package's modules, so that the tests build
    its JAX twin from the same code."""
    qs = quasistatic
    ball = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=2,
                           shapes=(geom.Circle((0., 0.), 0.2),))
    hand = geom.FreeBody2D(idx_pos=(3, 4), idx_rot=None,
                           shapes=(geom.Circle((0., 0.), 0.1),))
    world = geom.StaticBody(shapes=(geom.HalfSpace((0.0, 1.0), 0.0),
                                    geom.Circle((0.55, 0.15), 0.15)))
    return qs.QuasistaticModel(
        name="circle_pair", h=0.1, nq=5,
        models=(qs.ModelInstance("ball", (0, 1, 2), actuated=False,
                                 mass=(1.0, 1.0, 0.02)),
                qs.ModelInstance("hand", (3, 4), actuated=True,
                                 stiffness=(300.0, 300.0))),
        bodies=(ball, hand, world),
        pairs=(qs.ContactPair(body_a=1, body_b=0, mu=0.5),
               qs.ContactPair(body_a=2, body_b=0, shape_a=0, mu=0.5),
               qs.ContactPair(body_a=2, body_b=0, shape_a=1, mu=0.5)),
        gravity=(0.0, -10.0))


def long_arm_model(geom, quasistatic, links=6):
    """A model for arms of more than two links, which no bundled model has:
    a ball (y, z, th) on the ground, a ``links``-link arm from the left
    (links of 0.13, pointing up at zero angles) that reaches over it, and
    the planar hand's two-link arm shape from the right, every link against
    the ball.  ``geom`` and ``quasistatic`` are either package's modules, so
    that the tests build its JAX twin from the same code; at
    ``CONTACT_Q0["long_arm"]`` the last two links of the long arm touch the
    ball."""
    qs = quasistatic
    ball = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=2,
                           shapes=(geom.Circle((0., 0.), 0.25),))
    left = geom.Arm2D(base=(-0.5, 0.0), link_lengths=(0.13,) * links,
                      joint_idx=tuple(range(3, 3 + links)), radius=0.04,
                      angle_offset=np.pi)
    right = geom.Arm2D(base=(0.6, 0.0), link_lengths=(0.2, 0.2),
                       joint_idx=(3 + links, 4 + links), radius=0.04,
                       angle_offset=np.pi)
    ground = geom.StaticBody(shapes=(geom.HalfSpace((0.0, 1.0), 0.0),))
    pairs = [qs.ContactPair(body_a=arm, body_b=0, shape_a=k, mu=0.8)
             for arm, n in ((1, links), (2, 2)) for k in range(n)]
    pairs.append(qs.ContactPair(body_a=3, body_b=0, mu=0.8))
    return qs.QuasistaticModel(
        name="long_arm", h=0.1, nq=5 + links,
        models=(qs.ModelInstance("ball", (0, 1, 2), actuated=False,
                                 mass=(1.0, 1.0, 0.05)),
                qs.ModelInstance("arm_left", tuple(range(3, 3 + links)),
                                 actuated=True, stiffness=(50.0,) * links),
                qs.ModelInstance("arm_right", (3 + links, 4 + links),
                                 actuated=True, stiffness=(50.0, 25.0))),
        bodies=(ball, left, right, ground), pairs=tuple(pairs),
        gravity=(0.0, -10.0))


def long_arm_solver(device, T=LONG_ARM_T, num_samples=LONG_ARM_S):
    """The long-arm model (``long_arm_model``, six links) in the planar
    hand's configuration: roll the ball 0.1 to the right, Δu cost,
    trust-region input boxes of +-0.5h, std_u 0.3 decayed by 1/it**0.8,
    zero_order_B with decoupled A/B, boxed ADMM at 12 sweeps and the
    estimation surrogate; so an iteration is 2 K2, 1 K1, 1 K3 and 1 K4 on
    the card."""
    model = long_arm_model(geometry, quasistatic)
    idx_u = model.indices_u_into_x()
    x0 = np.asarray(CONTACT_Q0["long_arm"])
    xd = x0.copy()
    xd[:3] += (0.1, 0.0, -0.4)
    Q = np.diag([10.0, 10.0, 1.0] + [1e-3] * model.dim_u)
    params = IrsMpcParams(
        Q=Q, Qd=100 * Q, R=np.eye(model.dim_u), x0=x0,
        xd_trj=np.tile(xd, (T + 1, 1)), u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_abs=np.array([-np.ones(model.dim_u) * 0.5 * model.h,
                               np.ones(model.dim_u) * 0.5 * model.h]),
        bounds_trust_region=True, indices_u_into_x=idx_u,
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode="zero_order_B", decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.3, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        admm_iters=12, admm_over_relax=1.6, report_final_cost_with_Q=False,
        estimation_system=model.estimation_surrogate())
    return IrsMpc(model.system(), params, device=device), model


def swap_pairs(model):
    """``model`` with the two sides of every contact pair swapped: the
    other order of each pair kind, and normals of the other sign."""
    return dataclasses.replace(model, pairs=tuple(
        dataclasses.replace(p, body_a=p.body_b, body_b=p.body_a,
                            shape_a=p.shape_b, shape_b=p.shape_a)
        for p in model.pairs))


# Configurations in contact (those of the JAX package's kernel tests), in
# the models' dof order.
CONTACT_Q0 = {
    "planar_hand": [0.0, 0.35, 0.0, -np.pi / 4, -np.pi / 4, np.pi / 4,
                    np.pi / 4],
    "box_pushing": [0.0, 0.5, 0.0, 0.0, -0.12],
    "box_pivoting": [0.45, 0.5, 0.0, -0.15, 0.5],
    "plate_pickup": [0.0, 0.04, 0.0, 0.0, 0.30, 0.0, -0.16, -0.16],
    "circle_pair": [0.0, 0.2, 0.0, -0.31, 0.2],
    "long_arm": [0.0, 0.25, 0.0, -0.1, -0.25, -0.25, -0.25, -0.25, -0.25,
                 0.4, 0.6],
}


def chain_inputs(model, q0, A=3, T=10, aug=True, rel=False, seed=0,
                 device=DEVICE):
    """Line-search inputs for K4 around the configuration ``q0``: small
    random gains and references, and input boxes with an inf and a NaN
    entry (the NaN side is a no-op)."""
    nq, m = model.nq, model.dim_u
    g = torch.Generator().manual_seed(seed)
    q0 = torch.tensor(q0, dtype=torch.float32)
    u0 = q0[torch.from_numpy(model.indices_u_into_x())]
    nz = nq + m if aug else nq
    lb = torch.full((T, m), -0.05)
    ub = torch.full((T, m), 0.05)
    lb[:, 0], ub[:, 1] = -torch.inf, float("nan")
    args = dict(
        x0=q0, u_prev0=u0.clone(),
        K=torch.randn(T, m, nz, generator=g) * 0.5,
        z_ref_x=q0 + torch.randn(A, T, nq, generator=g) * 0.01,
        z_ref_w=(u0 + torch.randn(A, T, m, generator=g) * 0.01
                 if aug else None),
        u_ref=u0 + torch.randn(A, T, m, generator=g) * 0.03,
        lb=u0 + lb, ub=u0 + ub,
        rel_lb=torch.full((T, m), -0.02) if rel else None,
        rel_ub=torch.full((T, m), 0.02) if rel else None)
    return {k: (v.to(device) if v is not None else None)
            for k, v in args.items()}


def planar_hand_qps(B=2048, seed=0):
    """B planar-hand contact QPs (P, q, C, d) around the resting
    configuration, at the estimation sweep's spread (std_x 1e-3, std_u
    0.3), drawn with numpy (the construction of ``bench.py:334-353``)."""
    model = make_planar_hand(h=0.1)
    q0 = model.get_x_from_q_dict(HAND_Q0)
    rng = np.random.RandomState(seed)
    xs = q0[None] + 1e-3 * rng.randn(B, model.nq)
    us = q0[model.indices_u_into_x()][None] + 0.3 * rng.randn(B, model.dim_u)
    x = torch.tensor(xs, dtype=torch.float32, device=DEVICE)
    u = torch.tensor(us, dtype=torch.float32, device=DEVICE)
    P, q = model._hessian_and_bias(x, u)
    C, d = model._constraint_rows(x)
    return P.contiguous(), q, C, d


def delta_u_problem(T=30, n=7, m=4, seed=11, spread=0.3):
    """A seeded Δu-augmented problem (n_aug = n + m, w = x[n:]), the
    construction of ``tests/test_pallas.py::_delta_u_problem``; A is
    I + ``spread`` times a normal draw.  Past n ~ 30 the default spread makes
    the dynamics so unstable that float32 itself fixes the solution only to
    ~1e-3 (the plain loop's error against float64), so the wide shapes take
    near-identity dynamics (spread 0.03), as a quasistatic model's are."""
    rng = np.random.RandomState(seed)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=DEVICE)

    A = f(rng.randn(T, n, n) * spread + np.eye(n))
    B = f(rng.randn(T, n, m) * 0.5)
    c = f(rng.randn(T, n) * 0.1)
    Q = f(np.diag(rng.rand(n) + 0.5))
    R = f(np.diag(rng.rand(m) + 0.5))
    x0 = f(rng.randn(n))
    xd = f(rng.randn(T + 1, n) * 0.5)
    idx = torch.arange(m, device=DEVICE)
    return lqr.build_delta_u_problem(A, B, c, Q, Q * 3, R, x0, xd, idx), n


def delta_u_bounds(kinds, T, n_phys, m):
    """Boxes of the bound kinds ``kinds`` (the widths of the JAX package's
    all-kinds ADMM test)."""
    half = {"x": (T + 1, n_phys, 1.0), "u": (T, m, 0.3),
            "dx": (T, n_phys, 0.5), "du": (T, m, 0.2)}
    b = {}
    for kd in kinds:
        rows, dim, h = half[kd]
        b[kd] = torch.stack([torch.full((rows, dim), -h, device=DEVICE),
                             torch.full((rows, dim), h, device=DEVICE)])
    return admm.BoxBounds(**b)


def admm_initial(prob, bounds, n_phys, idx_w):
    """(z0, y0) as ``admm.solve_boxed_tvlqr`` starts them."""
    x0t, u0t, _ = lqr.lqr_solve(prob)
    s0 = admm._stage_values(prob, x0t, u0t, n_phys, idx_w)
    kinds = [kd for kd in admm.KINDS if getattr(bounds, kd) is not None]
    z0 = admm._SVals(**{kd: admm._clip(getattr(s0, kd), getattr(bounds, kd))
                        for kd in kinds})
    y0 = admm._SVals(**{kd: torch.zeros_like(getattr(z0, kd))
                        for kd in kinds})
    return z0, y0


def first_calls(solver, module, name, count, label):
    """The arguments of the ``count`` calls of ``module.name`` that the
    first iteration of ``solver`` makes on the card."""
    calls = []
    with capture(module, name, calls):
        solver.iterate(1, verbose=False)
    torch.cuda.synchronize()
    check(len(calls) == count, f"{label}: {len(calls)} calls of {name} in "
                               f"the first iteration, expected {count}")
    return calls


def qp_gaps(qps, iters, init=None, init_plain=None):
    """K2 and the plain PDIP on the same QPs ``(P, q, C, d)``, duals
    included; the plain solve starts from ``init_plain`` if given, else from
    ``init``.  Returns the kernel's (x, lam) and, for x and lam,
    max|kernel - plain| / max|plain|."""
    got = cuda_qp.solve_qp_batched_cuda(*qps, iters, init=init,
                                        want_lam=True)
    want = cuda_qp.solve_qp_batched_plain(
        *qps, iters, init=init if init_plain is None else init_plain,
        want_lam=True)
    torch.cuda.synchronize()
    rel = []
    for label, g, w in zip(("x", "lam"), got, want):
        check(bool(torch.isfinite(g).all()), f"K2: non-finite {label}")
        rel.append(((g - w).abs().max() / (w.abs().max() + 1e-12)).item())
    check(got[1].min().item() >= 0.0, "K2: negative duals")
    return got, want, rel


def admm_errors(prob, bounds, z0, y0, n_phys, idx_w, rho, iters,
                over_relax):
    """K3 against the plain loop on the same inputs; returns the max abs
    error and raises a SmokeFailure past the tolerances."""
    x, u, K, k, z, zp = cuda_admm.solve_boxed_tvlqr_cuda(
        prob, bounds, z0, y0, n_phys, idx_w, rho, iters, over_relax)
    xr, ur, gr, zr, zpr = admm._admm_plain(prob, bounds, z0, y0, n_phys,
                                           idx_w, rho, iters, over_relax)
    torch.cuda.synchronize()
    worst = 0.0
    for label, got, want in (("x", x, xr), ("u", u, ur), ("K", K, gr.K)):
        check(bool(torch.isfinite(got).all()), f"K3: non-finite {label}")
        err = (got - want).abs()
        worst = max(worst, err.max().item())
        check(bool((err <= ADMM_TOL + ADMM_TOL * want.abs()).all()),
              f"K3: {label} disagrees with the plain loop: max abs err "
              f"{err.max().item():.3e}")
    rk = admm._residuals(admm._stage_values(prob, x, u, n_phys, idx_w), z,
                         zp, bounds, rho)
    rp = admm._residuals(admm._stage_values(prob, xr, ur, n_phys, idx_w),
                         zr, zpr, bounds, rho)
    for label, got, want in zip(("r_primal", "r_dual"), rk, rp):
        got, want = got.item(), want.item()
        check(abs(got - want) <= ADMM_RES_RTOL * abs(want) + ADMM_TOL,
              f"K3: {label} {got:.6e} vs plain {want:.6e}")
    return worst


# ---------------------------------------------------------------------------
# Each kernel at one shape: checked against its plain version, timed, and
# set beside its bound, the least time the card could take for the same work
# ---------------------------------------------------------------------------

def tensor_bytes(obj):
    """Bytes of the tensors in ``obj`` (nested tuples, lists, dicts and
    dataclasses), each element counted once as the kernel reads it."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(o) for o in obj)
    return 0


def riccati_flops(T, n, m):
    """Operations of a Riccati backward pass with a cross term, per knot:
    A'PA, B'PB and B'PA (4n³ + 4n²m + 2nm²), the Gauss-Jordan solve of
    Quu against [Qux | qu] (2m²(m + n + 1)), the value update (2n²m) and
    the vector terms (4n² + 4nm)."""
    return T * (4 * n ** 3 + 6 * n ** 2 * m + 2 * n * m ** 2
                + 2 * m ** 2 * (m + n + 1) + 4 * n ** 2 + 4 * n * m)


def plan_flops(T, n, m):
    """Operations of the linear plan: per knot u = -(Kx + k) (2mn) and
    x = Ax + Bu + c (2n² + 2nm)."""
    return T * (2 * n * n + 4 * n * m)


def pdip_flops(B, n, m, iters):
    """Operations of ``iters`` PDIP iterations on B QPs of n unknowns and m
    rows: H = P + C'WC (2mn²), its Gauss-Jordan solve (2n²(n + 1)), the four
    products with C or C' (8mn) and the row-wise updates (~20m)."""
    return B * iters * (2 * m * n * n + 2 * n * n * (n + 1) + 8 * m * n
                        + 20 * m)


def admm_flops(T, n, m, iters):
    """Operations of K3: the Riccati factorisation with H⁻¹ (4m³ per
    knot), then per sweep and knot the affine backward pass, the rollout and
    the consensus updates (6n² + 10nm + 2m² + 10(n + m))."""
    return (riccati_flops(T, n, m) + T * 4 * m ** 3
            + iters * T * (6 * n * n + 10 * n * m + 2 * m * m
                           + 10 * (n + m)))


def chain_flops(A, T, nq, m, nz, rows, iters):
    """Operations of K4: per lane and knot the feedback law (2m·nz), the
    narrow phase and row assembly (~30 per row and unknown) and ``iters``
    PDIP iterations with a diagonal P (3·rows·nq² for H, 2nq²(nq + 1) for
    its solve, 8·rows·nq for the products, ~20 per row)."""
    return A * T * (iters * (3 * rows * nq * nq + 2 * nq * nq * (nq + 1)
                             + 8 * rows * nq + 20 * rows)
                    + 2 * m * nz + 30 * rows * nq)


def report(kernel, shape, card, err, ms, plain_ms, flops, nbytes):
    """One timed shape of a kernel, with its bound: the larger of its
    operations over the card's float32 peak and its bytes over its memory
    rate, and which of the two sets it."""
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    row = dict(kernel=kernel, shape=shape, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=nbytes)
    print(f"[{kernel}] {shape}: max abs err {err:.3e}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {row['bound_ms']:.3e} ms "
          f"(set by {row['bound_by']}; {flops:.4g} flop, {nbytes} B) "
          f"(median, CUDA events; {card})")
    return row


def plain_lqr_solve(prob):
    """K1's plain version with its plan: the plain loop, then
    ``lqr_rollout_linear`` on its gains."""
    gains = lqr.riccati_backward_plain(prob)
    return lqr.lqr_rollout_linear(prob, gains) + (gains.K, gains.k)


def k1_row(shape, prob, card, reps=(20, 5)):
    """K1 with its plan against the plain loop and plan: K, k, x and u
    each within REL_TOL of the largest plain value."""
    prob = lqr.LqrProblem(*(a.contiguous() for a in prob))
    T, n, m = prob.B.shape
    got = cuda_riccati.lqr_solve_cuda(prob)
    want = plain_lqr_solve(prob)
    torch.cuda.synchronize()
    err = 0.0
    for label, g, w in zip(("x", "u", "K", "k"), got, want):
        check(bool(torch.isfinite(g).all()),
              f"K1 {shape}: non-finite {label} from the kernel")
        diff = (g - w).abs().max().item()
        err = max(err, diff)
        rel = diff / w.abs().max().item()
        print(f"[K1] {shape}: rel err {label} {rel:.3e}")
        check(rel < REL_TOL, f"K1 {shape}: kernel {label} disagrees with the "
                             f"plain loop: rel err {rel:.3e} >= {REL_TOL}")
    print(f"[K1] {shape}: the knots' operands "
          f"{cuda_riccati.placement(T, n, m)}")
    ms = median_ms(lambda: cuda_riccati.lqr_solve_cuda(prob), reps[0])
    plain_ms = median_ms(lambda: plain_lqr_solve(prob), reps[1])
    return report("K1", shape + ", with the plan", card, err, ms, plain_ms,
                  riccati_flops(T, n, m) + plan_flops(T, n, m),
                  tensor_bytes(prob) + tensor_bytes(got))


def quantile_err(got, ref, pct, scale=None):
    """The ``pct`` quantile over QPs of max|got - ref| / ``scale``, by
    default max|ref|."""
    scale = (ref.abs().max().item() if scale is None else scale) + 1e-9
    return torch.quantile((got - ref).abs().amax(1) / scale, pct).item()


def k2_row(shape, qps, iters, card):
    """K2 against the plain PDIP on a main-path call's QPs, x and duals,
    at QP_REL_TOL.  Where float32 leaves the QPs' solution undetermined at
    that level, both are held against the float64 solve instead, the rule
    of the card test of the kernel's generic instance: at p90 and p99 the
    kernel is within 2.5x of the plain float32 solve's error."""
    (x, lam), (xp, lamp), rel = qp_gaps(qps, iters)
    B, n = qps[1].shape
    m = qps[3].shape[1]
    print(f"[K2] {shape}: {cuda_qp.lanes(n, m)} lanes a QP; kernel-plain "
          f"max rel err x {rel[0]:.3e}, lam {rel[1]:.3e}")
    if max(rel) > QP_REL_TOL:
        print(f"[K2] {shape}: past {QP_REL_TOL}; float32 does not determine "
              f"these QPs' solutions that closely, so both solves are held "
              f"against the float64 one")
        ref = cuda_qp.solve_qp_batched_plain(*(a.double() for a in qps),
                                             iters, want_lam=True)
        for label, got, plain, want in (("x", x, xp, ref[0].float()),
                                        ("lam", lam, lamp, ref[1].float())):
            apart = int(((got - plain).abs().amax(1)
                         > 1e-3 * plain.abs().max()).sum())
            print(f"[K2] {shape}: {label} of {apart} of {got.shape[0]} QPs "
                  f"apart by > 1e-3 of the largest; max err vs float64: "
                  f"kernel {quantile_err(got, want, 1.0):.3e}, plain "
                  f"{quantile_err(plain, want, 1.0):.3e} (not gated)")
            for pct in (0.9, 0.99):
                ek = quantile_err(got, want, pct)
                ep = quantile_err(plain, want, pct)
                print(f"[K2] {shape}: p{pct * 100:.0f} err vs float64 "
                      f"{label}: kernel {ek:.3e}, plain {ep:.3e}")
                check(ek <= max(2.5 * ep, 1e-6),
                      f"K2 {shape}: {label} less accurate than the plain "
                      f"PDIP at p{pct * 100:.0f}: {ek:.3e} vs {ep:.3e}")
    err = (x - xp).abs().max().item()
    ms = median_ms(lambda: cuda_qp.solve_qp_batched_cuda(*qps, iters), 20)
    plain_ms = median_ms(lambda: cuda_qp.solve_qp_batched_plain(*qps, iters),
                         5)
    return report("K2", shape, card, err, ms, plain_ms,
                  pdip_flops(B, n, m, iters),
                  tensor_bytes(qps) + x.numel() * x.element_size())


def k3_row(shape, args, kw, card, plain_reps=5):
    """K3 against the plain loop (``admm_errors``)."""
    err = admm_errors(*args, **kw)
    out = cuda_admm.solve_boxed_tvlqr_cuda(*args, **kw)
    ms = median_ms(lambda: cuda_admm.solve_boxed_tvlqr_cuda(*args, **kw), 20)
    plain_ms = median_ms(lambda: admm._admm_plain(
        *args, kw["n_phys"], kw["idx_w"], kw["rho"], kw["iters"],
        kw["over_relax"]), plain_reps)
    T, n, m = args[0].B.shape
    return report("K3", shape, card, err, ms, plain_ms,
                  admm_flops(T, n, m, kw["iters"]),
                  tensor_bytes(args) + tensor_bytes(kw) + tensor_bytes(out))


def k4_row(shape, args, card, plain_reps=3, float64_rule=False):
    """K4 against the plain chain: xs and us within CHAIN_ATOL.  With
    ``float64_rule`` (open-loop CEM populations, whose large first input
    jumps make the first warm knot's PDIP stall at a point that rounding
    decides), lanes past CHAIN_ATOL are allowed where both float32 chains
    are held against the float64 chain instead, the rule of ``k2_row``: at
    p90, p99 and the worst lane the kernel within 2.5x of the plain chain's
    error, and its lanes off the float64 chain by CHAIN_ATOL or more at
    most 2.5x as many as the plain chain's (at least 1)."""
    model = args[0]
    xs, us = cuda_rollout.linesearch_rollout_cuda(*args)
    xr, ur = rollout.linesearch_rollout_plain(*args)
    torch.cuda.synchronize()
    A, T, m = us.shape
    check(tuple(xs.shape) == (A, T + 1, model.nq)
          and bool(torch.isfinite(xs).all() and torch.isfinite(us).all()),
          f"K4 {shape}: bad trajectories")
    err = max((xs - xr).abs().max().item(), (us - ur).abs().max().item())
    if err >= CHAIN_ATOL and float64_rule:
        x64, _ = rollout.linesearch_rollout_plain(*(
            a.double() if torch.is_tensor(a) else a for a in args))
        lane_k = (xs.double() - x64).abs().amax((1, 2))
        lane_p = (xr.double() - x64).abs().amax((1, 2))
        apart = int(((xs - xr).abs().amax((1, 2)) >= CHAIN_ATOL).sum())
        off_k = int((lane_k >= CHAIN_ATOL).sum())
        off_p = int((lane_p >= CHAIN_ATOL).sum())
        print(f"[K4] {shape}: {apart} of {A} lanes apart by >= {CHAIN_ATOL} "
              f"(max {err:.3e}); lanes off float64 by >= {CHAIN_ATOL}: "
              f"kernel {off_k}, plain {off_p}")
        check(off_k <= max(2.5 * off_p, 1),
              f"K4 {shape}: {off_k} lanes off the float64 chain, the plain "
              f"chain {off_p}")
        for pct in (0.9, 0.99, 1.0):
            ek = torch.quantile(lane_k, pct).item()
            ep = torch.quantile(lane_p, pct).item()
            print(f"[K4] {shape}: p{pct * 100:.0f} err vs float64: kernel "
                  f"{ek:.3e}, plain {ep:.3e}")
            check(ek <= max(2.5 * ep, 1e-6),
                  f"K4 {shape}: less accurate than the plain chain at "
                  f"p{pct * 100:.0f}: {ek:.3e} vs {ep:.3e}")
    else:
        check(err < CHAIN_ATOL,
              f"K4 {shape}: disagrees with the plain chain: {err:.3e}")
    ms = median_ms(lambda: cuda_rollout.linesearch_rollout_cuda(*args), 20)
    plain_ms = median_ms(lambda: rollout.linesearch_rollout_plain(*args),
                         plain_reps)
    consts = cuda_rollout._consts(model, xs.device)
    nz = args[3].shape[-1]
    return report("K4", shape, card, err, ms, plain_ms,
                  chain_flops(A, T, model.nq, m, nz, consts["rows"],
                              model.qp_iters_ws),
                  tensor_bytes(args[1:]) + tensor_bytes(consts)
                  + tensor_bytes((xs, us)))


def admm_rows(name, k3_args, k3_kw, card):
    """K3 on the trajectory QP a slice's first iteration hands it, and K1
    on that problem's initial solve."""
    prob, bounds = k3_args[:2]
    Tp, n, m = prob.B.shape
    kinds = "+".join(kd for kd in admm.KINDS
                     if getattr(bounds, kd) is not None)
    print(f"[K3] {name}: the knots' operands {cuda_admm.placement(Tp, n, m)}")
    return [k3_row(f"{name} T={Tp} n={n} m={m}, {kinds} box, "
                   f"{k3_kw['iters']} sweeps, a={k3_kw['over_relax']}",
                   k3_args, k3_kw, card, plain_reps=3),
            k1_row(f"{name} T={Tp} n={n} m={m} (N!=0), the ADMM's "
                   f"initial solve", prob, card)]


def slice_kernel_rows(name, solver_fn, T, S, card, rollouts=1):
    """K2 (both calls), K3, K1 and K4 (unless ``rollouts=0``) on what the
    first iteration of the slice ``name`` hands them."""
    k2_calls, (k3_args, k3_kw), k4_call = first_iteration_inputs(
        solver_fn, rollouts)
    sizes = [(args[1].shape[0], args[4]) for args, _ in k2_calls]
    check(sizes == [(T, 30), (T * S, 15)],
          f"K2: {name} main-path (QPs, iterations) {sizes}, expected the "
          f"nominal {T} x 30 and the samples {T * S} x 15")
    rows = []
    for args, kwargs in k2_calls:
        # solve_qp_batched hands on (P, q, C, d, iters, sigma, init,
        # want_lam): the main path solves cold and without duals.
        check(len(args) == 8 and args[6] is None and not args[7]
              and not kwargs, "K2: main-path call not cold and dual-free")
        B, n = args[1].shape
        rows.append(k2_row(f"{name} {B} QPs x {args[4]} it, n={n} "
                           f"m={args[3].shape[1]}", args[:4], args[4], card))
    rows += admm_rows(name, k3_args, k3_kw, card)
    if not rollouts:
        return rows, None
    k4_args = k4_call[0]
    model = k4_args[0]
    A, T4, _ = k4_args[6].shape
    rows.append(k4_row(f"{name} {A} lanes x T={T4}, nq={model.nq}, "
                       f"{model.n_constraint_rows()} rows, first-iteration "
                       f"line search", k4_args, card, plain_reps=2))
    return rows, k4_args


def drive_slice(label, solver, iterations, per_it, card, rollouts):
    """Run ``iterations`` iterations of ``solver`` on the card with every
    launch count set to 0 just before and read just after; check the
    launches per iteration (``per_it``), that the trajectories stay on the
    card, finite and of their shapes.  K2's are those of an iteration
    whose estimation sweep runs eagerly: a sweep replayed from its CUDA
    graph (the tracer's ``est_graph``) launches none from the host, and
    its capture's warm-up (``est_capture``) launches them once.  Returns
    the launches and the median ms per iteration after the first."""
    for mod in KERNELS:
        mod.LAUNCHES = 0
    timing.reset()
    with timing.tracing():
        solver.iterate(iterations, verbose=False)
    torch.cuda.synchronize()
    sweeps = timing.counted("estimation")
    timing.reset()
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in KERNELS}
    print(f"[{label}] cost curve: "
          + " ".join(f"{c:.4f}" for c in solver.cost_lst))
    print(f"[{label}] launches in {iterations} iterations: {launches}; "
          f"estimation sweeps replayed {sweeps['est_graph']}, captured "
          f"{sweeps['est_capture']}")
    eager = iterations - sweeps["est_graph"] + sweeps["est_capture"]
    for name, n in per_it.items():
        want = n * (eager if name == "cuda_qp" else iterations)
        check(launches[name] == want,
              f"{label}: {launches[name]} launches of {name} in "
              f"{iterations} iterations, expected {want}")
    tensors = ([solver.x_trj, solver.u_trj, solver.Q, solver.Qd, solver.R,
                solver.x0, solver.xd_trj, solver.x_trj_best,
                solver.u_trj_best] + solver.x_trj_lst + solver.u_trj_lst)
    check(all(_nvcc.on_card(t) for t in tensors),
          f"{label}: a solver tensor is not on CUDA")
    T, n, m = solver.T, solver.system.dim_x, solver.system.dim_u
    check(tuple(solver.x_trj.shape) == (T + 1, n)
          and tuple(solver.u_trj.shape) == (T, m)
          and bool(torch.isfinite(solver.x_trj).all()
                   and torch.isfinite(solver.u_trj).all()),
          f"{label}: final trajectories wrong in shape or not finite")
    walls = [st.wall_time for st in solver.stats_lst]
    dt = statistics.median(walls[1:] or walls)
    print(f"[{label}] first iteration {walls[0] * 1e3:.2f} ms; then median "
          f"{dt * 1e3:.3f} ms/iteration, {rollouts / dt:.1f} rollouts/s; "
          f"best {solver.cost_best:.4f} ({card})")
    return launches, dt * 1e3


def drive_cem(label, solver, iterations, rollouts_per_it, card):
    """Run ``iterations`` CEM iterations on the card with every launch count
    set to 0 just before and read just after; check the K4 launches per
    iteration (``rollouts_per_it``: the population and the refit mean, or
    none), and none of K1-K3, and that the trajectories stay on the card,
    finite and of their shapes.  Returns the launches and the median ms
    per iteration after the first (host clock; each iteration ends in the
    host read of its cost)."""
    for mod in KERNELS:
        mod.LAUNCHES = 0
    walls = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        solver.iterate(1, verbose=False)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in KERNELS}
    print(f"[{label}] cost curve: "
          + " ".join(f"{c:.4f}" for c in solver.cost_lst))
    print(f"[{label}] launches in {iterations} iterations: {launches}")
    want = {"cuda_rollout": rollouts_per_it * iterations, "cuda_riccati": 0,
            "cuda_qp": 0, "cuda_admm": 0}
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    T, n, m = solver.T, solver.system.dim_x, solver.system.dim_u
    check(all(_nvcc.on_card(t) for t in [solver.x_trj, solver.u_trj,
                                         solver.std_trj, solver.x_trj_best]),
          f"{label}: a solver tensor is not on CUDA")
    check(tuple(solver.x_trj.shape) == (T + 1, n)
          and tuple(solver.u_trj.shape) == (T, m)
          and bool(torch.isfinite(solver.x_trj).all()
                   and torch.isfinite(solver.u_trj).all()),
          f"{label}: final trajectories wrong in shape or not finite")
    dt = statistics.median(walls[1:] or walls)
    B = solver.params.batch_size
    print(f"[{label}] first iteration {walls[0] * 1e3:.2f} ms; then median "
          f"{dt * 1e3:.3f} ms/iteration, {B * T / dt:.1f} rollout knots/s "
          f"({B} candidates x T={T}); best {solver.cost_best:.4f} ({card})")
    return launches, dt * 1e3


csv_curve = common.committed_curve


def check_golden(label, curve0, best, initial, best_max, best_min=0.0):
    """The contact goldens: the initial cost within 0.1 %, the best in
    [best_min, best_max]."""
    check(abs(curve0 - initial) <= 1e-3 * initial,
          f"{label}: initial cost {curve0} is not {initial} within 0.1%")
    check(best_min <= best <= best_max,
          f"{label}: best cost {best} is not in [{best_min}, {best_max}]")


def trace_device_ops(path):
    """The device operations of an exported Chrome trace: (category,
    name, microseconds, the host call that launched it), the call found
    by correlation id (None where the trace lacks it).  A CUDA graph's
    kernels appear one by one, each under its ``cudaGraphLaunch``."""
    launches, ops = {}, []
    for ev in json.loads(Path(path).read_text()).get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        corr = ev.get("args", {}).get("correlation")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append((cat, ev.get("name", ""), float(ev.get("dur", 0)),
                        corr))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = ev.get("name")
    return [(cat, name, us, launches.get(corr))
            for cat, name, us, corr in ops]


def profile_iteration(solver, iterations, card, logdir):
    """Where an iteration's time goes: ``iterations`` iterations with each
    phase timed on the host's clock from a device synchronisation to the
    next, then as many under ``profile_trace`` unsynchronised, for the
    device's busy share, its kernels by name (read from the exported
    trace, a CUDA graph's kernels included) and the program's own spans;
    the trace goes to ``logdir`` and must name K4's kernel and the
    ``irs/iteration`` span, and hold K2's two kernels under each replay
    of the estimation sweep's graph."""
    totals = collections.defaultdict(float)
    anchor = solver.x0                  # block_until_ready: the card

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                block_until_ready(anchor)
                totals[key] += time.perf_counter() - t0
        return run

    from irs_mpc_torch.solvers import irs_mpc
    patches = [(irs_mpc, "estimate_tv_matrices_fnom", "estimation"),
               (irs_mpc, "decouple_AB", "decouple_AB"),
               (irs_mpc.admm_ops, "solve_boxed_tvlqr",
                "boxed ADMM (K1 with its plan, K3)")]
    real = [getattr(mod, name) for mod, name, _ in patches]
    system = solver.system
    for mod, name, key in patches:
        setattr(mod, name, timed(key, getattr(mod, name)))
    solver._build_problem = timed("problem and bounds",
                                  solver._build_problem)
    solver._box_bounds = timed("problem and bounds", solver._box_bounds)
    solver.eval_cost = timed("cost of the lanes", solver.eval_cost)
    solver.system = dataclasses.replace(
        system, ls_rollout_fn=timed("line-search chain (K4)",
                                    system.ls_rollout_fn))
    total = 0.0
    try:
        for _ in range(iterations):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.iterate(1, verbose=False)
            block_until_ready(anchor)
            total += time.perf_counter() - t0
    finally:
        for (mod, name, _), fn in zip(patches, real):
            setattr(mod, name, fn)
        for name in ("_build_problem", "_box_bounds", "eval_cost"):
            delattr(solver, name)
        solver.system = system
    for key, s in totals.items():
        print(f"[profile] {key}: {s / iterations * 1e3:.3f} ms")
    rest = total - sum(totals.values())
    print(f"[profile] remainder: {rest / iterations * 1e3:.3f} ms; "
          f"iteration, synchronised: {total / iterations * 1e3:.3f} ms "
          f"(mean of {iterations}; {card})")

    torch.cuda.synchronize()
    timing.reset()
    with profile_trace(logdir):
        t0 = time.perf_counter()
        solver.iterate(iterations, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = Path(logdir) / "trace.json"
    text = trace.read_text() if trace.exists() else ""
    check("rollout_kernel" in text and "irs/iteration" in text,
          f"profile: {trace} is missing, or names no K4 kernel or no "
          f"irs/iteration span")
    print(f"[profile] trace {trace}: {trace.stat().st_size} bytes, names "
          f"K4's rollout_kernel and the program's spans; their host ms "
          f"over {iterations} iterations, unsynchronised:")
    print(timing.report())
    replays = timing.counted("estimation")["est_graph"]
    timing.reset()
    by_name = collections.defaultdict(float)
    count = k2_replayed = 0
    for cat, name, us, launched_by in trace_device_ops(trace):
        by_name[name] += us / 1e3
        if cat == "kernel":
            count += 1
            k2_replayed += ("pdip_kernel" in name
                            and launched_by == "cudaGraphLaunch")
    busy = sum(by_name.values())
    if not count:
        print("[profile] the profiler recorded no device events: busy "
              "share not measured")
        return
    print(f"[profile] K2 kernels run by the estimation graph's replays: "
          f"{k2_replayed} in {replays} replays")
    check(k2_replayed == 2 * replays,
          f"profile: {k2_replayed} K2 kernels under cudaGraphLaunch in "
          f"{replays} replays of the estimation sweep, expected 2 each")
    print(f"[profile] {iterations} iterations unsynchronised: "
          f"{wall * 1e3 / iterations:.3f} ms each; {count / iterations:.1f} "
          f"device kernels per iteration; device busy {busy:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall, busy share {busy / (wall * 1e3):.4f}, "
          f"idle share {1 - busy / (wall * 1e3):.4f} ({card})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]   {ms / iterations:.3f} ms/iteration  {name[:70]}")
    print(f"[profile] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")


def contact_models():
    """Every model of the narrow phase's card check: the bundled models
    within K4's limits and the circle-circle model."""
    return {"planar_hand": make_planar_hand(),
            "box_pushing": make_box_pushing(),
            "box_pivoting": make_box_pivoting(),
            "plate_pickup": make_plate_pickup(),
            "circle_pair": circle_pair_model(geometry, quasistatic)}


class Lap:
    """Prints each phase's wall seconds on its own line."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase):
        now = time.perf_counter()
        print(f"[phase {phase}] wall {now - self.t:.2f} s")
        self.t = now


def cem_population_row(label, builder, card):
    """K4 against its plain chain on the first population of a contact
    CEM (every candidate an open-loop lane, K = 0), recorded from the
    solver's first iteration on the card."""
    cem, model = builder(DEVICE)
    # Two calls: the population's and the refit mean's.
    args = first_calls(cem, cuda_rollout, "linesearch_rollout_cuda", 2,
                       label)[0][0]
    A, T, _ = args[6].shape
    check(A == cem.params.batch_size and not args[3].any(),
          f"{label}: the population call is not {cem.params.batch_size} "
          f"open-loop lanes")
    return k4_row(f"{label} population {A} lanes x T={T}, nq={model.nq}, "
                  f"{model.n_constraint_rows()} rows, K = 0", args, card,
                  plain_reps=2, float64_rule=True)


def phase_cem(card, rows, paths):
    """Phase 14: K4 on the first population of the two contact CEM
    searches it takes (rows added to ``rows``), then every CEM
    configuration of ``CEM_CASES`` on the card (launches into ``paths``)."""
    rows.append(cem_population_row("planar_hand CEM", planar_hand_cem, card))
    rows.append(cem_population_row("box_pushing CEM", box_pushing_cem, card))
    for label, builder, iters, initial, csv, per_it, one_sided in CEM_CASES:
        out = globals()[builder](DEVICE)
        cem = out[0] if isinstance(out, tuple) else out
        paths[label], _ = drive_cem(label, cem, iters, per_it, card)
        curve = csv_curve(csv)
        print(f"[{label}] initial {cem.cost_lst[0]:.4f} (float32 {initial}, "
              f"committed curve {curve[0]:.4f}); best {cem.cost_best:.4f} "
              f"(committed curve's last {curve[-1]:.4f}, min "
              f"{curve.min():.4f})")
        check(abs(cem.cost_lst[0] - initial) <= CEM_INITIAL_RTOL * initial,
              f"{label}: initial cost {cem.cost_lst[0]} is not {initial} "
              f"within 0.1%")
        best_max = ((1 + CEM_BEST_RTOL) * curve[-1] if one_sided
                    else cem.cost_lst[0])
        check(np.isfinite(cem.cost_best) and cem.cost_best < best_max,
              f"{label}: best cost {cem.cost_best} is not below {best_max}")


def phase_resolve(card, paths):
    """Phase 15: K3 and K1 on a masked knot problem of the planar hand's
    and of the pendulum's first resolve iteration (returns their rows),
    then resolve mode on the pendulum with a binding box (against the
    feedback mode on the same problem) and on the planar hand."""
    rows = []
    for label, solver, T_r in (
            ("planar_hand resolve",
             planar_hand_solver(DEVICE, forward_mode="resolve")[0], HAND_T),
            ("pendulum resolve",
             IrsMpc(make_pendulum(0.05), pendulum_resolve_params("resolve"),
                    device=DEVICE), RESOLVE_T)):
        calls = first_calls(solver, cuda_admm, "solve_boxed_tvlqr_cuda", T_r,
                            label)
        rows += admm_rows(f"{label} knot {T_r // 2}", *calls[T_r // 2], card)
    per_knot = {"cuda_riccati": RESOLVE_T, "cuda_admm": RESOLVE_T,
                "cuda_qp": 0, "cuda_rollout": 0}
    rs = IrsMpc(make_pendulum(0.05), pendulum_resolve_params("resolve"),
                device=DEVICE)
    paths["pendulum_resolve"], _ = drive_slice(
        "pendulum resolve", rs, RESOLVE_ITERATIONS, per_knot, card,
        RESOLVE_T)
    fb = IrsMpc(make_pendulum(0.05), pendulum_resolve_params("feedback"),
                device=DEVICE)
    drive_slice("pendulum feedback, the same problem", fb,
                RESOLVE_FEEDBACK_ITERATIONS,
                {"cuda_riccati": 1, "cuda_admm": 1}, card, RESOLVE_T)
    u_max = rs.u_trj_lst[-1].abs().max().item()
    gap = abs(rs.cost_best - fb.cost_best) / fb.cost_best
    print(f"[pendulum resolve] max |u| {u_max:.6f} (box {RESOLVE_U_MAX}); "
          f"best {rs.cost_best:.4f} against the feedback mode's "
          f"{fb.cost_best:.4f}: {gap:.4f} apart")
    check(u_max <= RESOLVE_U_MAX + 1e-3, f"resolve: |u| {u_max} past the box")
    check(gap < RESOLVE_BEST_RTOL,
          f"resolve: best {rs.cost_best} is {gap:.3f} from the feedback "
          f"mode's {fb.cost_best}")
    solver, _ = planar_hand_solver(DEVICE, forward_mode="resolve")
    paths["planar_hand_resolve"], _ = drive_slice(
        "planar_hand resolve", solver, HAND_RESOLVE_ITERATIONS,
        {"cuda_qp": 2, "cuda_riccati": HAND_T, "cuda_admm": HAND_T,
         "cuda_rollout": 0}, card, HAND_T * HAND_S)
    check(abs(solver.cost_lst[0] - HAND_INITIAL) <= 1e-3 * HAND_INITIAL,
          f"planar_hand resolve: initial cost {solver.cost_lst[0]}")
    check(bool(np.isfinite(solver.cost_lst).all()),
          f"planar_hand resolve: cost curve {solver.cost_lst}")
    return rows


def phase_plate_pickup(card, paths):
    """Phase 16: K2 (both calls), K3 and K1 on plate pickup's first
    iteration (returns their rows), its golden with exact launches, and
    one first_order iteration, which reaches K2 through the surrogate's
    batched step."""
    rows = slice_kernel_rows("plate_pickup", plate_pickup_solver, PLATE_T,
                             PLATE_S, card, rollouts=0)[0]
    bests = []
    for seed in PLATE_SEEDS:
        solver, _ = plate_pickup_solver(DEVICE, seed=seed)
        check(solver.system.ls_rollout_fn is None,
              "plate_pickup: chain_gate should keep K4 off its fingers")
        launches, _ = drive_slice(
            f"plate_pickup seed {seed}", solver, PLATE_ITERATIONS,
            {"cuda_riccati": 1, "cuda_qp": 2, "cuda_admm": 1,
             "cuda_rollout": 0}, card, PLATE_T * PLATE_S)
        paths.setdefault("plate_pickup", launches)
        check_golden(f"plate_pickup seed {seed}", solver.cost_lst[0],
                     solver.cost_best, PLATE_INITIAL, solver.cost_lst[0])
        bests.append(solver.cost_best)
    median = statistics.median(bests)
    print(f"[plate_pickup] best over seeds 0-{PLATE_SEEDS[-1]}: "
          + " ".join(f"{b:.4f}" for b in bests)
          + f"; median {median:.4f} (golden {PLATE_BEST} +- 12 %)")
    check(abs(median - PLATE_BEST) <= BOX_BEST_RTOL * PLATE_BEST,
          f"plate_pickup: median best {median} is not {PLATE_BEST} within "
          f"12%")
    solver, _ = plate_pickup_solver(DEVICE, gradient_mode="first_order")
    paths["plate_pickup_first_order"], _ = drive_slice(
        "plate_pickup first_order", solver, 1,
        {"cuda_qp": 1, "cuda_riccati": 1, "cuda_admm": 1, "cuda_rollout": 0},
        card, PLATE_T * PLATE_S)
    return rows


def phase_analytic(card, paths):
    """Phase 17: K1 on the quadrotor's first-iteration problem, K3 and K1
    on the three carts' (returns their rows), then both iRS examples on the
    card, held to their committed curves."""
    call = first_calls(quadrotor_solver(DEVICE), cuda_riccati,
                       "lqr_solve_cuda", 1, "quadrotor")[0]
    prob = call[0][0]
    Tq, n, m = prob.B.shape
    rows = [k1_row(f"quadrotor T={Tq} n={n} m={m}, first iteration", prob,
                   card)]
    call = first_calls(three_cart_solver(DEVICE), cuda_admm,
                       "solve_boxed_tvlqr_cuda", 1, "three_cart")[0]
    rows += admm_rows("three_cart", *call, card)
    for label, solver, iters, initial, csv, per in (
            ("quadrotor", quadrotor_solver(DEVICE), QUAD_ITERATIONS,
             QUAD_INITIAL, "quadrotor_zero_order", {"cuda_admm": 0}),
            ("three_cart", three_cart_solver(DEVICE), CART_ITERATIONS,
             CART_INITIAL, "three_cart_zero_order", {"cuda_admm": 1})):
        paths[label], _ = drive_slice(
            label, solver, iters,
            dict(per, cuda_riccati=1, cuda_qp=0, cuda_rollout=0), card,
            solver.T * solver.params.smoothing.num_samples)
        target = csv_curve(csv).min()
        print(f"[{label}] best {solver.cost_best:.4f} against the committed "
              f"curve's minimum {target:.4f}")
        check_golden(label, solver.cost_lst[0], solver.cost_best, initial,
                     (1 + BOX_BEST_RTOL) * target,
                     (1 - BOX_BEST_RTOL) * target)
    return rows


MBP_PER_IT = {"cuda_riccati": 1, "cuda_admm": 1, "cuda_qp": 0,
              "cuda_rollout": 0}


def phase_second_order(card, paths):
    """Phase 18: every path of ``MBP_PATHS`` for 10 iterations: 1 K1 and 1
    K3 an iteration, no K2 and no K4, held to the committed curves (the
    torque spin on the median of its seeds); K3 and K1 on the trajectory
    QP of the first iteration at each second-order shape (returns their
    rows and the Δu problem)."""
    rows, shapes = [], {}
    for (label, builder, kw, initial, csv, two_sided, seeds,
         ref) in MBP_PATHS:
        build = globals()[builder]
        solver, _ = build(DEVICE, **kw)
        calls = []
        with capture(cuda_admm, "solve_boxed_tvlqr_cuda", calls):
            paths[label], _ = drive_slice(
                label, solver, MBP_ITERATIONS, MBP_PER_IT, card,
                solver.T * solver.params.smoothing.num_samples)
        shape = (builder, kw.get("control_mode", "position"))
        if shape not in shapes:
            call = calls[0]
            if label in MBP_ROWS_FROM:
                admm_float64_note(label, *call)
                call = first_calls(
                    build(DEVICE, **dict(kw, **MBP_ROWS_FROM[label]))[0],
                    cuda_admm, "solve_boxed_tvlqr_cuda", 1, label)[0]
            shapes[shape] = call[0][0]
            rows += admm_rows(label, *call, card)
        bests = [solver.cost_best]
        for seed in range(1, seeds):
            other, _ = build(DEVICE, seed=seed, **kw)
            other.iterate(MBP_ITERATIONS, verbose=False)
            bests.append(other.cost_best)
        best = statistics.median(bests)
        target = (csv_curve(csv)[MBP_ITERATIONS] if ref is None else ref)
        print(f"[{label}] initial {solver.cost_lst[0]:.4f} (float32 "
              f"{initial}); best {best:.4f}"
              + (f" (median of seeds 0-{seeds - 1}: "
                 + " ".join(f"{b:.4f}" for b in bests) + ")"
                 if seeds > 1 else "")
              + f" against {target:.4f} ("
              + (f"the committed curve at {MBP_ITERATIONS}" if ref is None
                 else "the JAX package's median over seeds") + ")")
        check_golden(label, solver.cost_lst[0], best, initial,
                     (1 + MBP_BEST_RTOL) * target,
                     (1 - MBP_BEST_RTOL) * target if two_sided else 0.0)
    return rows, shapes[("planar_hand_second_solver", "position")]


def admm_float64_note(label, args, kw):
    """K3 and the plain loop on a boxed problem, each against the plain
    loop in float64: max|x - x64|, |u - u64| and |K - K64| over the
    float64 solution's largest entry (printed, not gated)."""
    def wide(t):
        return None if t is None else t.double()

    prob, bounds, z0, y0 = args
    args64 = (lqr.LqrProblem(*map(wide, prob)),
              admm.BoxBounds(*map(wide, bounds)),
              admm._SVals(*map(wide, z0)), admm._SVals(*map(wide, y0)))
    rest = (kw["n_phys"], kw["idx_w"], kw["rho"], kw["iters"],
            kw["over_relax"])
    x64, u64, g64, _, _ = admm._admm_plain(*args64, *rest)
    x, u, g, _, _ = admm._admm_plain(*args, *rest)
    xk, uk, Kk, _, _, _ = cuda_admm.solve_boxed_tvlqr_cuda(*args, **kw)
    def rel(got, ref):
        return ((got.double() - ref).abs().max() / ref.abs().max()).item()

    radius = torch.linalg.eigvals(prob.A).abs().max().item()
    print(f"[K3] {label} first iteration's own problem (A's spectral "
          f"radius {radius:.2f}), relative to float64: " + "; ".join(
              f"{name} plain {rel(p, r):.3e} kernel {rel(k, r):.3e}"
              for name, p, k, r in (("x", x, xk, x64), ("u", u, uk, u64),
                                    ("K", g.K, Kk, g64.K)))
          + " (not gated)")


def phase_second_order_cem(card, paths):
    """Phase 19: the second-order CEM (16000 x T=30, 50 iterations): its
    population through the plant's warm chains as plain PyTorch, no
    kernel launched."""
    cem, _ = planar_hand_second_cem(DEVICE)
    paths["planar_hand_second_cem"], _ = drive_cem(
        "planar_hand_second_cem", cem, MBP_CEM_ITERATIONS, 0, card)
    curve = csv_curve("planar_hand_second_cem")
    target = curve[MBP_CEM_ITERATIONS]
    print(f"[planar_hand_second_cem] initial {cem.cost_lst[0]:.4f} (float32 "
          f"{MBP_CEM_INITIAL}, committed curve {curve[0]:.4f}); best "
          f"{cem.cost_best:.4f} (committed curve at {MBP_CEM_ITERATIONS}: "
          f"{target:.4f})")
    check_golden("planar_hand_second_cem", cem.cost_lst[0], cem.cost_best,
                 MBP_CEM_INITIAL, (1 + MBP_BEST_RTOL) * target)


def assoc_row(shape, prob, kind, card):
    """The associative-scan pass against K1 (K, k) and against the plain
    sequential pass (K, k, P), each as max|assoc - ref| / max|ref|, and the
    three timed."""
    prob = lqr.LqrProblem(*(a.contiguous() for a in prob))
    got = lqr.riccati_backward_assoc(prob)
    K1 = cuda_riccati.riccati_backward_cuda(prob)
    plain = lqr.riccati_backward_plain(prob)
    torch.cuda.synchronize()
    errs = {}
    for label, ref in (("K1", dict(K=K1[0], k=K1[1])),
                       ("plain", dict(K=plain.K, k=plain.k, P=plain.P))):
        for name, want in ref.items():
            g = getattr(got, name)
            check(bool(torch.isfinite(g).all()), f"assoc {shape}: {name}")
            errs[f"{name} vs {label}"] = ((g - want).abs().max()
                                          / want.abs().max()).item()
    ms = median_ms(lambda: lqr.riccati_backward_assoc(prob), 10)
    k1_ms = median_ms(lambda: cuda_riccati.riccati_backward_cuda(prob), 20)
    plain_ms = median_ms(lambda: lqr.riccati_backward_plain(prob), 3)
    print(f"[assoc] {shape}: rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; assoc {ms:.4f} ms, K1 {k1_ms:.4f} ms, plain loop "
          f"{plain_ms:.3f} ms (median, CUDA events; {card})")
    worst = max(errs.values())
    check(worst < ASSOC_TOL[kind], f"assoc {shape}: rel err {worst:.3e} >= "
                                   f"{ASSOC_TOL[kind]}")
    return dict(shape=shape, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms,
                max_rel_err=worst)


def phase_assoc(card, paths, prob_du):
    """Phase 20: the associative scan against K1 and the plain pass at the
    pendulum, the bench shape and the second-order Δu shape
    (``prob_du``), then the pendulum's exact iterations with
    parallel_riccati: no K1 or K3 launch, the cost within 1e-3 of the K1
    path's."""
    pend, _ = pendulum_problems()
    T_du, n_du, m_du = prob_du.B.shape
    rows = [assoc_row("pendulum T=200 n=2 m=1", pend, "tracking", card),
            assoc_row("bench T=200 n=16 m=4", bench_problem(), "tracking",
                      card),
            assoc_row(f"planar_hand_second delta-u T={T_du} n={n_du} "
                      f"m={m_du}", prob_du, "delta_u", card)]
    costs = {}
    for parallel in (False, True):
        solver = IrsMpc(make_pendulum(0.05), pendulum_params(
            "exact", parallel_riccati=parallel), device=DEVICE)
        label = "pendulum exact" + (" parallel_riccati" if parallel else "")
        launches, _ = drive_slice(
            label, solver, ASSOC_ITERATIONS,
            {"cuda_riccati": 0 if parallel else 1, "cuda_admm": 0,
             "cuda_qp": 0, "cuda_rollout": 0}, card, T)
        if parallel:
            paths["pendulum_parallel_riccati"] = launches
        costs[parallel] = solver.cost
    gap = abs(costs[True] - costs[False]) / costs[False]
    print(f"[pendulum parallel_riccati] cost {costs[True]:.4f} against the K1 "
          f"path's {costs[False]:.4f}: {gap:.3e} apart")
    check(gap < ASSOC_COST_RTOL, f"parallel_riccati: cost {costs[True]} is "
                                 f"{gap:.3e} from {costs[False]}")
    return rows


def phase_learned(card, paths):
    """Phase 21: ``examples/pendulum_nn.py`` on the card over seeds 0-7:
    train the MLP, swing up through it in exact and zero-order (seed 0's
    with exact launch counts: 1 K1 an iteration), cost each plan on the
    true pendulum; K1 at the learned swing-up's shape.  The medians are
    held to the JAX package's."""
    def drive(label, solver, iterations):
        key = label.replace(" ", "_")
        paths[key], _ = drive_slice(
            label, solver, iterations,
            {"cuda_riccati": 1, "cuda_admm": 0, "cuda_qp": 0,
             "cuda_rollout": 0}, card, solver.T * 500)

    table = []
    for seed in MLP_SEEDS:
        t0 = time.perf_counter()
        loss, out = learned_pendulum(DEVICE, seed=seed,
                                     drive=drive if seed == 0 else None)
        table.append(dict(loss=loss, **{m: c for m, (_, c) in out.items()}))
        print(f"[learned pendulum] seed {seed}: training loss {loss:.6g}; "
              + "; ".join(f"{m} best {s.cost_best:.4f}, plan on the true "
                          f"pendulum {c:.4f}" for m, (s, c) in out.items())
              + f" ({time.perf_counter() - t0:.2f} s)")
        check(all(np.isfinite(list(table[-1].values()))),
              f"learned pendulum seed {seed}: {table[-1]}")
        if seed == 0:
            nn_sys = out["exact"][0].system
    call = first_calls(IrsMpc(nn_sys, pendulum_nn_params("exact"),
                              device=DEVICE), cuda_riccati, "lqr_solve_cuda",
                       1, "learned pendulum")[0]
    prob = call[0][0]
    Tl, n, m = prob.B.shape
    row = k1_row(f"learned pendulum T={Tl} n={n} m={m}, first iteration",
                 prob, card)
    for key, ref in MLP_JAX_MEDIANS.items():
        med = statistics.median(r[key] for r in table)
        print(f"[learned pendulum] median {key} over seeds "
              f"0-{MLP_SEEDS[-1]}: {med:.6g} (the JAX package's {ref}; "
              f"ratio {med / ref:.4f})")
        check(med <= MLP_RATIO * ref, f"learned pendulum: median {key} "
                                      f"{med} > {MLP_RATIO} x {ref}")
    return [row]


def phase_sharding(card, paths):
    """Phase 22: a one-rank NCCL group (``multihost.initialize`` with a
    ``file://`` rendezvous in a temporary directory), a 2 x 2 ``pod_mesh``
    of the card's cells; the five modes' sharded estimates against the
    single-device ones at the pendulum and the planar hand, then the
    pendulum solver on the mesh against the single-device run."""
    import torch.distributed as dist

    from irs_mpc_torch.ops.estimators import estimate_tv_matrices
    from irs_mpc_torch.parallel import multihost
    from irs_mpc_torch.parallel.sharded import sharded_estimate_tv_matrices

    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{tmp}/rendezvous", world_size=1,
                             rank=0)
        try:
            check(dist.get_backend() == "nccl", "sharding: not NCCL")
            mesh = multihost.pod_mesh(knot_shards=2,
                                      local_devices=[DEVICE] * 4)
            check(mesh.distributed and mesh.shape == {"sample": 2, "knot": 2},
                  f"sharding: mesh {mesh.shape}")
            hand, _ = planar_hand_solver(DEVICE)
            pend = IrsMpc(make_pendulum(0.05), pendulum_nn_params(
                "zero_order", T=100, num_samples=800), device=DEVICE)
            for label, solver, cfg in (
                    ("pendulum T=100", pend,
                     SmoothingConfig(num_samples=800, std_x=0.3, std_u=0.3)),
                    ("planar hand T=30", hand, SmoothingConfig(
                        num_samples=50, std_x=1e-3, std_u=0.3,
                        zero_order_B_A_source="first_order"))):
                system = solver.system
                for mode in ("exact", "first_order", "zero_order",
                             "zero_order_B", "zero_order_AB"):
                    args = (system, mode, solver.x_trj, solver.u_trj)
                    got = sharded_estimate_tv_matrices(
                        *args, torch.Generator(DEVICE).manual_seed(0), 1,
                        cfg, mesh)
                    want = estimate_tv_matrices(
                        *args, torch.Generator(DEVICE).manual_seed(0), 1,
                        cfg)
                    # A and B against their largest entry; c = f - A x -
                    # B u against the largest of the terms it cancels.  A
                    # sample Jacobian of the contact step can be NaN; both
                    # routes must have it at the same entries.
                    A, B = want.A.nan_to_num(), want.B.nan_to_num()
                    scales = (A.abs().max(), B.abs().max(), max(
                        (A @ solver.x_trj[:-1, :, None]).abs().max(),
                        (B @ solver.u_trj[:, :, None]).abs().max()))
                    errs = [((a - b).nan_to_num().abs().max() / sc).item()
                            for a, b, sc in zip(got, want, scales)]
                    nans = [int(b.isnan().sum()) for b in want]
                    print(f"[sharding] {label} {mode}: rel err A, B, c "
                          + " ".join(f"{e:.3e}" for e in errs)
                          + f"; NaN entries {nans} in both")
                    check(max(errs) <= SHARD_REL_TOL and all(
                        torch.equal(a.isnan(), b.isnan())
                        for a, b in zip(got, want)),
                        f"sharding {label} {mode}: rel err {errs}")
            costs = {}
            for on_mesh in (False, True):
                solver = IrsMpc(make_pendulum(0.05), pendulum_params(
                    "zero_order", T=100, num_samples=800,
                    mesh=mesh if on_mesh else None), device=DEVICE)
                label = "pendulum" + (" on the 2 x 2 mesh" if on_mesh
                                      else " single-device")
                launches, _ = drive_slice(
                    label, solver, SHARD_ITERATIONS,
                    {"cuda_riccati": 1, "cuda_admm": 0, "cuda_qp": 0,
                     "cuda_rollout": 0}, card, 100 * 800)
                if on_mesh:
                    paths["pendulum_mesh"] = launches
                costs[on_mesh] = solver.cost
            gap = abs(costs[True] - costs[False]) / costs[False]
            print(f"[sharding] pendulum on the mesh {costs[True]:.4f}, "
                  f"single-device {costs[False]:.4f}: {gap:.3e} apart")
            check(gap < SHARD_COST_RTOL, f"sharding: cost gap {gap}")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


# Phase 23: box pushing on the LCP contact model (examples/box_pushing.py:
# 117-138), zero_order_AB at its 21 descents: 2 K2, 1 K1 and 1 K3 an
# iteration and no K4 (``rollout.supports_model`` refuses the LCP model, as
# the JAX package's gate does); the curve held by the runner's rule.
LCP_CURVE, LCP_ITERATIONS = "box_pushing_lcp_zero_order_AB", 21
LCP_PER_IT = {"cuda_qp": 2, "cuda_riccati": 1, "cuda_admm": 1,
              "cuda_rollout": 0}
# The pendulum slice checkpointed after 2 iterations and resumed for 3
# equals 5 iterations straight, bit for bit (the same draws from the
# restored generator state, the same kernels).
CKPT_FIRST, CKPT_REST = 2, 3


def phase_lcp(card, paths):
    """Phase 23: K2 against the plain PDIP on the two calls of the first
    iteration of box pushing on the LCP model in zero_order_AB (returns
    their rows); that path's curve at its budget under the runner's rule,
    with exact launches; a checkpoint resumed on the card; the LCP step's
    boundary layer on the card."""
    from irs_mpc_torch.examples import run_all
    from irs_mpc_torch.utils import checkpoint, config

    solver, model = box_pushing.build_lcp_solver("zero_order_AB",
                                                 device=DEVICE)
    check(model.contact_model == "lcp" and not rollout.supports_model(model)
          and solver.system.ls_rollout_fn is None,
          "box pushing LCP: K4 must refuse the LCP model")
    rows = []
    T, S = solver.T, solver.params.smoothing.num_samples
    calls = first_calls(solver, cuda_qp, "solve_qp_batched_cuda", 2,
                        "box_pushing lcp")
    sizes = [(args[1].shape[0], args[4]) for args, _ in calls]
    check(sizes == [(T, 30), (T * S, 15)],
          f"K2: box_pushing lcp (QPs, iterations) {sizes}")
    for args, _ in calls:
        B, n = args[1].shape
        C, d = args[2], args[3]
        open_rows = int(((C.abs().amax(-1) == 0) & (d == 1)).sum())
        print(f"[K2] box_pushing lcp {B} QPs: {open_rows} of {d.numel()} "
              f"rows masked to 0 dq <= 1 (separated pairs)")
        rows.append(k2_row(f"box_pushing lcp {B} QPs x {args[4]} it, n={n} "
                           f"m={d.shape[1]}", args[:4], args[4], card))

    solver, _ = box_pushing.build_lcp_solver("zero_order_AB", device=DEVICE)
    paths[LCP_CURVE], _ = drive_slice(LCP_CURVE, solver, LCP_ITERATIONS,
                                      LCP_PER_IT, card, T * S)
    drifts, best = run_all.check_curve(
        solver.cost_lst, csv_curve(LCP_CURVE),
        run_all.RULES.get(LCP_CURVE, run_all.DEFAULT), DEVICE)
    print(f"[{LCP_CURVE}] best {best:.4f} against the committed curve's "
          f"{csv_curve(LCP_CURVE).min():.4f} (+-12 %); "
          + ("; ".join(drifts) or "ok"))
    check(not drifts, f"{LCP_CURVE}: " + "; ".join(drifts))

    def pendulum_solver():
        return IrsMpc(make_pendulum(0.05), pendulum_params("zero_order"),
                      device=DEVICE)

    straight = pendulum_solver()
    straight.iterate(CKPT_FIRST + CKPT_REST, verbose=False)
    first = pendulum_solver()
    first.iterate(CKPT_FIRST, verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_checkpoint(Path(tmp) / "pendulum.npz", first)
        resumed = pendulum_solver()
        checkpoint.load_checkpoint(path, resumed)
    check(resumed.iter == first.iter and resumed.u_trj.is_cuda
          and resumed.generator.device.type == "cuda",
          "checkpoint: the resumed solver is not the saved one on the card")
    resumed.iterate(CKPT_REST, verbose=False)
    torch.cuda.synchronize()
    gap = (resumed.u_trj - straight.u_trj).abs().max().item()
    print(f"[checkpoint] pendulum {CKPT_FIRST} + {CKPT_REST} iterations "
          f"against {CKPT_FIRST + CKPT_REST} straight: u_trj max |diff| "
          f"{gap:.3e}, cost {resumed.cost:.6f} / {straight.cost:.6f}")
    check(torch.equal(resumed.u_trj, straight.u_trj)
          and resumed.cost_lst == straight.cost_lst,
          f"checkpoint: the resumed run is not the straight one ({gap})")

    x = torch.tensor([0., 0.5, 0., 0., -0.13], device=DEVICE)[None]
    u = torch.tensor([0., -0.03], device=DEVICE)[None]
    ani = config.make_system("box_pushing", 0.1).step(x, u)[0, 1].item()
    lcp = config.make_system("box_pushing", 0.1,
                             contact_model="lcp").step(x, u)[0, 1].item()
    print(f"[make_system] box y after a gap-closing step: anitescu {ani:.6f}"
          f", lcp {lcp:.6f} (open gap: no reaction)")
    check(ani > 0.5 + 1e-3 and abs(lcp - 0.5) < 1e-4,
          f"make_system lcp boundary layer: anitescu {ani}, lcp {lcp}")
    return rows


def phase_closing(card, paths):
    """Phase 24: K4 (and K2, K3, K1) on the long-arm model, a six-link arm
    in its link table, held against their plain versions on its first
    iteration and on built inputs with the pairs' sides swapped, then its
    solver with exact launches; the bundle study's deterministic parts
    against the JAX study's (``examples/bundle_study_jax.json``); the
    estimator comparison; the multi-rank dry run on one NCCL rank.
    Returns the kernels' rows."""
    import torch.distributed as dist

    from irs_mpc_torch.examples import (bundle_study, dryrun, run_all,
                                        planar_hand_second_order_estimators
                                        as estimators)
    from irs_mpc_torch.parallel import multihost

    rows, _ = slice_kernel_rows("long_arm", long_arm_solver, LONG_ARM_T,
                                LONG_ARM_S, card)
    model = swap_pairs(long_arm_model(geometry, quasistatic))
    args = (model,) + tuple(chain_inputs(model, CONTACT_Q0["long_arm"],
                                         aug=True, rel=True,
                                         device=DEVICE).values())
    rows.append(k4_row(f"long_arm (sides swapped) 3 lanes x T=10, "
                       f"nq={model.nq}, {model.n_constraint_rows()} rows, "
                       f"built inputs", args, card))
    solver, model = long_arm_solver(DEVICE)
    check(rollout.supports_model(model) and rollout.chain_gate(model)
          and len(model.bodies[1].link_lengths) == 6,
          "long arm: K4 must take the six-link arm")
    paths["long_arm"], _ = drive_slice(
        "long_arm", solver, LONG_ARM_ITERATIONS,
        {"cuda_riccati": 1, "cuda_qp": 2, "cuda_admm": 1, "cuda_rollout": 1},
        card, LONG_ARM_T * LONG_ARM_S)
    check_golden("long_arm", solver.cost_lst[0], solver.cost_best,
                 LONG_ARM_INITIAL, np.nextafter(solver.cost_lst[0], 0))

    ref = json.loads(run_all.BUNDLE_JAX.read_text())
    det = bundle_study.deterministic(DEVICE)
    for key, want in (("exact_slope", [ref["exact_slope"]]),
                      ("sweep", ref["sweep"]),
                      ("true_Anitescu", ref["true_Anitescu"]),
                      ("true_LCP", ref["true_LCP"])):
        err = float(np.abs(np.atleast_1d(det[key]) - np.asarray(want)).max())
        print(f"[bundle study] {key}: max abs err {err:.3e} against the JAX "
              f"study on the CPU ({run_all.BUNDLE_JAX.name})")
        check(err <= run_all.BUNDLE_ATOL,
              f"bundle study {key}: {err:.3e} > {run_all.BUNDLE_ATOL}")

    mbp = planar_hand_second_order.make_mbp("position")
    x0, u0 = estimators.probe_state(mbp)
    _, est_rows = estimators.compare(mbp.system(), x0, u0,
                                     generator=torch.Generator(
                                         DEVICE).manual_seed(0))
    for mode, err_a, err_b, rel_a, rel_b in est_rows:
        print(f"[estimators] {mode}: rel_err_A {rel_a:.6f}, rel_err_B "
              f"{rel_b:.6f}")
        check(rel_b <= 0.02, f"estimators {mode}: rel_err_B {rel_b} > 0.02")

    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{tmp}/rendezvous", world_size=1,
                             rank=0)
        try:
            check(dist.get_backend() == "nccl", "dry run: not NCCL")
            dryrun.dryrun(DEVICE)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    return rows


def main():
    lap = Lap()
    # -- Phase 0: environment ------------------------------------------------
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    nvcc = _nvcc.nvcc_path()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout
    print(f"nvcc {nvcc}: {nvcc_version.strip().splitlines()[-1]}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}  (torch: {kind}, {torch.cuda.device_count()} "
          f"device(s))")
    lap(0)

    # -- Phase 1: build K1-K4, one nvcc each, all at once --------------------
    t0 = time.perf_counter()
    libs = _nvcc.build_all([mod.LIB for mod in KERNELS])
    print(f"[build] {len(libs)} kernels: {time.perf_counter() - t0:.2f} s")
    for mod, path in zip(KERNELS, libs):
        print(f"[build] {path.name}: nvcc {mod.LIB.seconds:.2f} s")
        for line in mod.LIB.log.splitlines():
            if ("registers" in line or "smem" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build]   {line.strip()}")
    lap(1)

    # -- Phase 2: K1 against the plain loop on the card ----------------------
    pend, pend_du = pendulum_problems()
    rows = [k1_row(shape, prob, card, reps=(50, 10)) for shape, prob in (
        ("pendulum T=200 n=2 m=1", pend),
        ("bench T=200 n=16 m=4", bench_problem()),
        ("delta-u T=200 n=3 m=1 (N!=0)", pend_du),
        ("delta-u T=4 n=20 m=5 (N!=0, wide block)",
         delta_u_problem(T=4, n=15, m=5, seed=3, spread=0.03)[0]))]
    lap(2)

    # -- Phase 3: the pendulum slice on the card -----------------------------
    solver = IrsMpc(make_pendulum(0.05), pendulum_params("zero_order"),
                    device=DEVICE)
    paths = {"pendulum": drive_slice("pendulum", solver, ITERATIONS,
                                     {"cuda_riccati": 1}, card,
                                     T * NUM_SAMPLES)[0]}
    curve = solver.cost_lst
    check(abs(curve[0] - INITIAL_COST) < INITIAL_TOL,
          f"initial cost {curve[0]} is not {INITIAL_COST} ± {INITIAL_TOL}")
    check(solver.cost <= FINAL_COST_MAX,
          f"final cost {solver.cost} > {FINAL_COST_MAX}")
    check(solver.cost_best <= FINAL_COST_MAX,
          f"best cost {solver.cost_best} > {FINAL_COST_MAX}")
    lap(3)

    # -- Phases 4-6: K2, K3, K1 and K4 on the planar hand's first iteration,
    # K2 on 2048 contact QPs and K3 on every bound kind -----------------------
    hand_rows, hand_k4 = slice_kernel_rows("planar_hand", planar_hand_solver,
                                           HAND_T, HAND_S, card)
    rows += hand_rows
    P, q, C, d = planar_hand_qps()
    (x_k, lam_k), (x_p, lam_p), rel = qp_gaps((P, q, C, d), 30)
    x_conv = cuda_qp.solve_qp_batched_plain(P, q, C, d, 120)
    torch.cuda.synchronize()
    scale = x_conv.abs().max().item()
    p90_k, p90_p = (quantile_err(x_k, x_conv, 0.9),
                    quantile_err(x_p, x_conv, 0.9))
    p50_agree = quantile_err(x_k, x_p, 0.5, scale)
    print(f"[K2] 2048 planar-hand QPs, cold 30 it: p90 err vs converged "
          f"{p90_k:.3e} (plain {p90_p:.3e}); p50 kernel-plain {p50_agree:.3e};"
          f" max rel err kernel-plain x {rel[0]:.3e}, lam {rel[1]:.3e}")
    check(p90_k < max(2.5 * p90_p, 5e-2),
          f"K2 less accurate than the plain PDIP: p90 {p90_k} vs {p90_p}")
    check(p50_agree < 2e-2, f"K2/plain bulk disagreement: p50 {p50_agree}")
    check(max(rel) <= QP_REL_TOL,
          f"K2 disagrees with the plain PDIP on 2048 QPs: rel err x "
          f"{rel[0]:.3e}, lam {rel[1]:.3e} > {QP_REL_TOL}")
    # Warm, each from its own cold (x, lam): the kernel's whole chain
    # against the plain one's.
    (x_w, _), (x_wp, _), rel_w = qp_gaps((P, q, C, d), 6, init=(x_k, lam_k),
                                         init_plain=(x_p, lam_p))
    p90_w = quantile_err(x_w, x_conv, 0.9)
    p50_w = quantile_err(x_w, x_wp, 0.5, scale)
    print(f"[K2] warm 6 it from (x, lam): p90 err vs converged {p90_w:.3e};"
          f" p50 kernel-plain {p50_w:.3e}; max rel err kernel-plain x "
          f"{rel_w[0]:.3e}, lam {rel_w[1]:.3e}")
    check(p90_w < max(2.5 * p90_k, 5e-2), f"K2 warm start: p90 {p90_w}")
    check(p50_w < 2e-2, "K2 warm: bulk disagreement")
    check(max(rel_w) <= QP_WARM_REL_TOL,
          f"K2 warm start disagrees with the plain PDIP: rel err x "
          f"{rel_w[0]:.3e}, lam {rel_w[1]:.3e} > {QP_WARM_REL_TOL}")
    rows.append(k2_row("planar-hand check 2048 QPs x 30 it, n=7 m=10",
                       (P, q, C, d), 30, card))

    prob_du, n_phys = delta_u_problem()
    Tp, n_aug, m_du = prob_du.B.shape
    idx_w = torch.arange(n_phys, n_aug, device=DEVICE)
    for kinds in (("x",), ("dx",), ("x", "u"), ("du",), ("u", "du")):
        bounds = delta_u_bounds(kinds, Tp, n_phys, m_du)
        z0, y0 = admm_initial(prob_du, bounds, n_phys, idx_w)
        err = admm_errors(prob_du, bounds, z0, y0, n_phys=n_phys,
                          idx_w=idx_w, rho=5.0, iters=12,
                          over_relax=1.6)
        print(f"[K3] delta-u T=30 n=11 m=4, kinds {'+'.join(kinds)}: max "
              f"abs err {err:.3e}")
    # The wide shapes and both placements of the knots' operands.
    for n_p, m_w, T_w in ((34, 16, 5), (48, 16, 5), (48, 16, 12)):
        prob_w, _ = delta_u_problem(T=T_w, n=n_p, m=m_w, seed=3, spread=0.03)
        n_w = n_p + m_w
        idx = torch.arange(n_p, n_w, device=DEVICE)
        bounds = delta_u_bounds(("u", "du"), T_w, n_p, m_w)
        z0, y0 = admm_initial(prob_w, bounds, n_p, idx)
        rows.append(k3_row(
            f"delta-u T={T_w} n={n_w} m={m_w}, u+du box, 8 sweeps, "
            f"{cuda_admm.placement(T_w, n_w, m_w)}", (prob_w, bounds, z0, y0),
            dict(n_phys=n_p, idx_w=idx, rho=1.0, iters=8, over_relax=1.6),
            card))
    prob_b = bench_problem()
    Tb, n_b, m_b = prob_b.B.shape
    bounds = admm.BoxBounds(**{kd: torch.stack(
        [torch.full((rows_, dim), -h, device=DEVICE),
         torch.full((rows_, dim), h, device=DEVICE)])
        for kd, rows_, dim, h in (("x", Tb + 1, n_b, 1.0),
                                  ("u", Tb, m_b, 0.3))})
    z0, y0 = admm_initial(prob_b, bounds, n_b, None)
    rows.append(k3_row(
        f"bench T={Tb} n={n_b} m={m_b}, x+u box, 12 sweeps, "
        f"{cuda_admm.placement(Tb, n_b, m_b)}", (prob_b, bounds, z0, y0),
        dict(n_phys=n_b, idx_w=None, rho=1.0, iters=12, over_relax=1.6),
        card, plain_reps=2))
    lap("4-6")

    # -- Phase 7: the planar-hand slice on the card --------------------------
    per_it = {"cuda_riccati": 1, "cuda_qp": 2, "cuda_admm": 1,
              "cuda_rollout": 1}
    solver, _ = planar_hand_solver(DEVICE)
    paths["planar_hand"], _ = drive_slice("hand", solver, HAND_ITERATIONS,
                                          per_it, card, HAND_T * HAND_S)
    check_golden("planar hand", solver.cost_lst[0], solver.cost_best,
                 HAND_INITIAL, (1 + HAND_BEST_RTOL) * HAND_BEST,
                 (1 - HAND_BEST_RTOL) * HAND_BEST)
    lap(7)

    # -- Phase 8: the box slices' kernels on their first iteration -----------
    box_k4 = {}
    for name, fn, Tb in (("box_pushing", box_pushing_solver, BOX_PUSHING_T),
                         ("box_pivoting", box_pivoting_solver,
                          BOX_PIVOTING_T)):
        new_rows, box_k4[name] = slice_kernel_rows(name, fn, Tb, BOX_S, card)
        rows += new_rows
    lap(8)

    # -- Phase 9: K4 on every pair kind, in both orders ----------------------
    # The slices' first-iteration line searches again with every pair's
    # sides swapped (the same contacts, normals of the other sign), and
    # built inputs for plate pickup and the circle-circle model.
    searches = dict(box_k4, planar_hand=hand_k4)
    for name, model in contact_models().items():
        for swapped in (False, True):
            m = swap_pairs(model) if swapped else model
            order = "sides swapped" if swapped else "as built"
            if name in searches:
                if not swapped:
                    continue                  # phases 6 and 8
                args = (m,) + searches[name][1:]
                shape = f"{name} ({order}) first-iteration line search"
            else:
                args = (m,) + tuple(chain_inputs(
                    m, CONTACT_Q0[name], aug=True, rel=True).values())
                shape = (f"{name} ({order}) 3 lanes x T=10, nq={m.nq}, "
                         f"{m.n_constraint_rows()} rows, built inputs")
            rows.append(k4_row(shape, args, card))
    lap(9)

    # -- Phase 10: the box-pushing slice on the card -------------------------
    solver, _ = box_pushing_solver(DEVICE)
    paths["box_pushing"], push_ms = drive_slice(
        "box_pushing", solver, BOX_ITERATIONS, per_it, card,
        BOX_PUSHING_T * BOX_S)
    check_golden("box_pushing", solver.cost_lst[0], solver.cost_best,
                 BOX_PUSHING_INITIAL, (1 + BOX_BEST_RTOL) * BOX_PUSHING_BEST,
                 (1 - BOX_BEST_RTOL) * BOX_PUSHING_BEST)
    lap(10)

    # -- Phase 11: the box-pivoting slice on the card, and its scan chain ----
    solver, _ = box_pivoting_solver(DEVICE)
    paths["box_pivoting"], _ = drive_slice(
        "box_pivoting", solver, BOX_ITERATIONS, per_it, card,
        BOX_PIVOTING_T * BOX_S)
    check_golden("box_pivoting", solver.cost_lst[0], solver.cost_best,
                 BOX_PIVOTING_INITIAL,
                 (1 + BOX_BEST_RTOL) * BOX_PIVOTING_BEST)
    # The same solver without its whole-chain rollout: the line search runs
    # the per-knot warm chain, the JAX package's scan chain.
    scan = IrsMpc(dataclasses.replace(solver.system, ls_rollout_fn=None),
                  solver.params, device=DEVICE)
    drive_slice("box_pivoting scan chain", scan, BOX_ITERATIONS,
                dict(per_it, cuda_rollout=0), card, BOX_PIVOTING_T * BOX_S)
    check(scan.cost_lst[0] == solver.cost_lst[0],
          "box_pivoting: the scan chain starts from another cost")
    lap(11)

    # -- Phase 12: where a box-pushing iteration's time goes -----------------
    solver, _ = box_pushing_solver(DEVICE)
    solver.iterate(1, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    profile_iteration(solver, 3, card, _nvcc.BUILD_DIR / "trace")
    lap(12)

    # -- Phase 13: carrots: K3 and K1 at its shape, then its path -----------
    k3_calls = []
    solver, _ = carrots_solver(DEVICE)
    with capture(cuda_admm, "solve_boxed_tvlqr_cuda", k3_calls):
        solver.iterate(1, verbose=False)
    torch.cuda.synchronize()
    check(len(k3_calls) == 1,
          f"carrots first iteration: {len(k3_calls)} ADMM calls")
    rows += admm_rows("carrots", *k3_calls[0], card)
    solver, _ = carrots_solver(DEVICE)
    paths["carrots"], _ = drive_slice(
        "carrots", solver, CARROTS_ITERATIONS,
        {"cuda_riccati": 1, "cuda_admm": 1, "cuda_qp": 0, "cuda_rollout": 0},
        card, CARROTS_T * CARROTS_S)
    check_golden("carrots", solver.cost_lst[0], solver.cost_best,
                 CARROTS_INITIAL, (1 + BOX_BEST_RTOL) * CARROTS_BEST,
                 (1 - BOX_BEST_RTOL) * CARROTS_BEST)

    lap(13)

    phase_cem(card, rows, paths)
    lap(14)
    rows += phase_resolve(card, paths)
    lap(15)
    rows += phase_plate_pickup(card, paths)
    lap(16)
    rows += phase_analytic(card, paths)
    lap(17)
    new_rows, prob_du = phase_second_order(card, paths)
    rows += new_rows
    lap(18)
    phase_second_order_cem(card, paths)
    lap(19)
    assoc = phase_assoc(card, paths, prob_du)
    lap(20)
    rows += phase_learned(card, paths)
    lap(21)
    phase_sharding(card, paths)
    lap(22)
    rows += phase_lcp(card, paths)
    lap(23)
    rows += phase_closing(card, paths)
    lap(24)

    entries = []
    for kernel, name, source, replaces in (
            ("K1", "riccati_backward", "irs_mpc_torch/csrc/riccati.cu",
             "irs_mpc_tpu/ops/pallas_riccati.py:46"),
            ("K2", "pdip_batched", "irs_mpc_torch/csrc/pdip.cu",
             "irs_mpc_tpu/models/contact/pallas_qp.py:33"),
            ("K3", "admm_boxed", "irs_mpc_torch/csrc/admm.cu",
             "irs_mpc_tpu/ops/pallas_admm.py:53"),
            ("K4", "rollout_chain", "irs_mpc_torch/csrc/rollout.cu",
             "irs_mpc_tpu/models/contact/pallas_rollout.py:613")):
        mod = KERNELS[int(kernel[1]) - 1]
        key = mod.__name__.rsplit(".", 1)[1]
        by_path = {path: counts[key] for path, counts in paths.items()
                   if counts[key]}
        mine = [r for r in rows if r["kernel"] == kernel]
        # The headline shape: this slice's, box pushing (its samples for
        # K2).
        head = next(r for r in mine if r["shape"].startswith("box_pushing")
                    and (kernel != "K2"
                         or f"{BOX_PUSHING_T * BOX_S} QPs" in r["shape"]))
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=head["max_abs_err"], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=None, shape=head["shape"],
            shapes=[{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "max_abs_err")}
                    for r in mine]))
    # K4 on the six-link arm (phase 24), a row of its own.
    arm = next(r for r in rows if r["kernel"] == "K4"
               and r["shape"].startswith("long_arm "))
    entries.append(dict(
        name="rollout_chain (six-link arm)", route="cuda",
        source="irs_mpc_torch/csrc/rollout.cu",
        replaces="irs_mpc_tpu/models/contact/pallas_rollout.py:613",
        launches=paths["long_arm"]["cuda_rollout"],
        launches_by_path={"long_arm": paths["long_arm"]["cuda_rollout"]},
        max_abs_err=arm["max_abs_err"], ms=arm["ms"],
        plain_ms=arm["plain_ms"], bound_ms=arm["bound_ms"],
        bound_by=arm["bound_by"], library_ms=None, shape=arm["shape"]))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
