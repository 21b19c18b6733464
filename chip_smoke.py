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
2. holds K1 against the plain PyTorch loop on the card at three problems
   (pendulum T=200 n=2 m=1; a T=200 n=16 m=4 random problem; a Δu problem
   with a cross term) and times both;
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
   the planar-hand slice's first iteration and on five bound-kind
   combinations of a seeded Δu problem, and K1 against its plain loop on
   that first-iteration problem, and times both;
6. holds K4 against the plain lane-batched chain on the line search of the
   slice's first iteration (6 lanes, T=30), and times both;
7. drives the planar-hand iRS-MPC slice (T=30, 50 samples per knot,
   zero_order_B, boxed ADMM, 8 iterations) on the card: initial cost
   325.0136 within 0.1%, best within 12% of 22.26, and per iteration
   exactly 2 launches of K2 and 1 each of K1, K3 and K4.

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from irs_mpc_torch import (IrsMpc, IrsMpcParams, SmoothingConfig,
                           make_pendulum, make_planar_hand)
from irs_mpc_torch.models.contact import cuda_qp, cuda_rollout, rollout
from irs_mpc_torch.ops import _nvcc, admm, cuda_admm, cuda_riccati, lqr

REL_TOL = 1e-3          # max|ΔK| / max|K| and the same for k
INITIAL_COST = 1856.1541
INITIAL_TOL = 0.01
FINAL_COST_MAX = 360.0
T, NUM_SAMPLES, ITERATIONS = 200, 1000, 9

# The planar-hand slice and its goldens (tests/test_golden_contact.py).
HAND_T, HAND_S, HAND_ITERATIONS = 30, 50, 8
HAND_INITIAL, HAND_INITIAL_RTOL = 325.0136, 1e-3
HAND_BEST, HAND_BEST_RTOL = 22.26, 0.12
# K3 and K4 against their plain versions: x, u, K at rtol/atol 1e-3 and
# the residuals at rtol 1e-2 (the JAX package's whole-loop ADMM check);
# the chain's xs, us at atol 5e-3 (its whole-chain rollout check).
ADMM_TOL, ADMM_RES_RTOL, CHAIN_ATOL = 1e-3, 1e-2, 5e-3
# K2 against the plain PDIP on the same QPs, x and the duals each as
# max|kernel - plain| / max|plain|: cold solves (the main path's two
# calls, the 2048-QP check) and a warm start from the duals, which
# amplifies the gap about tenfold.
QP_REL_TOL, QP_WARM_REL_TOL = 1e-5, 1e-4
KERNELS = (cuda_riccati, cuda_qp, cuda_admm, cuda_rollout)
DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def bench_problem(T=T):
    """The random T=200, n=16, m=4 tracking problem, made from numpy seed 1
    by the construction of the JAX package's Riccati benchmark."""
    n, m = 16, 4
    rng = np.random.RandomState(1)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=DEVICE)

    A = f(np.eye(n)[None] + 0.05 * rng.randn(T, n, n))
    B = f(0.3 * rng.randn(T, n, m))
    c = f(0.05 * rng.randn(T, n))
    x0 = f(rng.randn(n))
    return lqr.build_tracking_problem(
        A, B, c, f(np.eye(n)), f(10.0 * np.eye(n)), f(np.eye(m)), x0,
        f(np.zeros((T + 1, n))))


HAND_Q0 = {"sphere": np.array([0.0, 0.35, 0.0]),
           "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
           "arm_right": np.array([np.pi / 4, np.pi / 4])}


def planar_hand_solver(device, T=HAND_T, num_samples=HAND_S):
    """The planar-hand configuration of the JAX package's benchmark and
    example (``bench.py::build_planar_hand_solver``): Δu mode, trust-region
    input boxes of +-0.5h, zero_order_B with decoupled A/B, boxed ADMM at
    12 over-relaxed sweeps, and the 15-iteration estimation surrogate."""
    model = make_planar_hand(h=0.1)
    idx_u = model.indices_u_into_x()
    q0 = HAND_Q0
    x0 = model.get_x_from_q_dict(q0)
    xd = model.get_x_from_q_dict({
        "sphere": q0["sphere"] + np.array([0.3, -0.1, 0.5]),
        "arm_left": q0["arm_left"], "arm_right": q0["arm_right"]})
    Q_dict = {"sphere": np.array([1e-3, 1e-3, 10.0]),
              "arm_left": np.array([1e-3, 1e-3]),
              "arm_right": np.array([1e-3, 1e-3])}
    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict({k: v * 100 for k, v in Q_dict.items()}),
        R=model.get_R_from_R_dict({"arm_left": 5 * np.ones(2),
                                   "arm_right": 5 * np.ones(2)}),
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_abs=np.array([-np.ones(4) * 0.5 * model.h,
                               np.ones(4) * 0.5 * model.h]),
        bounds_trust_region=True, indices_u_into_x=idx_u,
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode="zero_order_B", decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.3, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        admm_iters=12, admm_over_relax=1.6, report_final_cost_with_Q=False,
        estimation_system=model.estimation_surrogate())
    return IrsMpc(model.system(), params, device=device), model


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


def delta_u_problem(T=30, n=7, m=4, seed=11):
    """A seeded Δu-augmented problem (n_aug = n + m, w = x[n:]), the
    construction of ``tests/test_pallas.py::_delta_u_problem``."""
    rng = np.random.RandomState(seed)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=DEVICE)

    A = f(rng.randn(T, n, n) * 0.3 + np.eye(n))
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


@contextlib.contextmanager
def capture(module, name, calls):
    """Record the arguments of every call of ``module.name`` in ``calls``
    (the call goes through unchanged)."""
    real = getattr(module, name)

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, real)


def first_iteration_inputs():
    """The arguments the planar-hand slice's first iteration hands K2 (its
    two calls), K3 and K4, recorded from a solver run on the card."""
    k2, k3, k4 = [], [], []
    solver, _ = planar_hand_solver(DEVICE)
    with capture(cuda_qp, "solve_qp_batched_cuda", k2), \
            capture(cuda_admm, "solve_boxed_tvlqr_cuda", k3), \
            capture(cuda_rollout, "linesearch_rollout_cuda", k4):
        solver.iterate(1, verbose=False)
    torch.cuda.synchronize()
    check(len(k2) == 2 and len(k3) == 1 and len(k4) == 1,
          f"first iteration: {len(k2)} QP, {len(k3)} ADMM and {len(k4)} "
          f"rollout calls")
    return k2, k3[0], k4[0]


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


def main():
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

    # -- Phase 2: K1 against the plain loop on the card ----------------------
    pend, pend_du = pendulum_problems()
    cases = [("pendulum T=200 n=2 m=1", pend),
             ("bench T=200 n=16 m=4", bench_problem()),
             ("delta-u T=200 n=3 m=1 (N!=0)", pend_du)]
    results = []
    for name, prob in cases:
        prob = lqr.LqrProblem(*(a.contiguous() for a in prob))
        ref = lqr.riccati_backward_plain(prob)
        K, k = cuda_riccati.riccati_backward_cuda(prob)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(K).all() and torch.isfinite(k).all()),
              f"{name}: non-finite gains from the kernel")
        errs = {}
        for label, got, want in (("K", K, ref.K), ("k", k, ref.k)):
            abs_err = (got - want).abs().max().item()
            errs[label] = (abs_err, abs_err / want.abs().max().item())
        ms = median_ms(lambda: cuda_riccati.riccati_backward_cuda(prob), 50)
        plain_ms = median_ms(lambda: lqr.riccati_backward_plain(prob), 10)
        print(f"[K1] {name}: rel err K {errs['K'][1]:.3e}, "
              f"k {errs['k'][1]:.3e}; kernel {ms:.4f} ms, plain loop "
              f"{plain_ms:.3f} ms (median, CUDA events; {card})")
        for label in ("K", "k"):
            check(errs[label][1] < REL_TOL,
                  f"{name}: kernel {label} disagrees with the plain loop: "
                  f"rel err {errs[label][1]:.3e} >= {REL_TOL}")
        results.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                            max_abs_err=max(e[0] for e in errs.values())))

    # -- Phase 3: the pendulum slice on the card -----------------------------
    params = IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode="zero_order",
        smoothing=SmoothingConfig(num_samples=NUM_SAMPLES, std_x=1.0,
                                  std_u=1.0))
    cuda_riccati.LAUNCHES = 0
    solver = IrsMpc(make_pendulum(0.05), params, device=DEVICE)
    solver.iterate(ITERATIONS, verbose=False)
    torch.cuda.synchronize()
    launches = cuda_riccati.LAUNCHES

    curve = solver.cost_lst
    print("[slice] cost curve: " + " ".join(f"{c:.4f}" for c in curve))
    check(abs(curve[0] - INITIAL_COST) < INITIAL_TOL,
          f"initial cost {curve[0]} is not {INITIAL_COST} ± {INITIAL_TOL}")
    check(solver.cost <= FINAL_COST_MAX,
          f"final cost {solver.cost} > {FINAL_COST_MAX}")
    check(solver.cost_best <= FINAL_COST_MAX,
          f"best cost {solver.cost_best} > {FINAL_COST_MAX}")
    check(launches == ITERATIONS,
          f"{launches} Riccati kernel launches in {ITERATIONS} iterations")
    tensors = ([solver.x_trj, solver.u_trj, solver.Q, solver.Qd, solver.R,
                solver.x0, solver.xd_trj, solver.x_trj_best,
                solver.u_trj_best] + solver.x_trj_lst + solver.u_trj_lst)
    check(all(_nvcc.on_card(t) for t in tensors),
          "a solver tensor is not on CUDA")
    check(tuple(solver.x_trj.shape) == (T + 1, 2)
          and tuple(solver.u_trj.shape) == (T, 1)
          and bool(torch.isfinite(solver.x_trj).all()
                   and torch.isfinite(solver.u_trj).all()),
          "final trajectories have the wrong shape or are not finite")
    walls = [s.wall_time for s in solver.stats_lst]
    dt = statistics.median(walls[1:])
    print(f"[slice] first iteration {walls[0] * 1e3:.2f} ms; then median "
          f"{dt * 1e3:.3f} ms/iteration, {T * NUM_SAMPLES / dt:.1f} smoothed "
          f"rollouts/s; K1 launches {launches} ({card})")

    pend_launches = launches

    # -- Phase 4: K2 against the plain batched PDIP --------------------------
    k2_calls, (k3_args, k3_kw), (k4_args, _) = first_iteration_inputs()
    k2_err = 0.0
    sizes = [(args[1].shape[0], args[4]) for args, _ in k2_calls]
    check(sizes == [(HAND_T, 30), (HAND_T * HAND_S, 15)],
          f"K2: main-path (QPs, iterations) {sizes}, expected the nominal "
          f"{HAND_T} x 30 and the samples {HAND_T * HAND_S} x 15")
    for args, kwargs in k2_calls:
        # solve_qp_batched hands on (P, q, C, d, iters, sigma, init,
        # want_lam): the main path solves cold and without duals.
        check(len(args) == 8 and args[6] is None and not args[7]
              and not kwargs, "K2: main-path call not cold and dual-free")
        qps, iters = args[:4], args[4]
        (x_m, _), (x_mp, _), rel = qp_gaps(qps, iters)
        k2_err = max(k2_err, (x_m - x_mp).abs().max().item())
        print(f"[K2] main path, {qps[1].shape[0]} QPs x {iters} it: "
              f"kernel-plain max rel err x {rel[0]:.3e}, lam {rel[1]:.3e}")
        check(max(rel) <= QP_REL_TOL,
              f"K2 disagrees with the plain PDIP on the main path's "
              f"{qps[1].shape[0]} QPs: rel err x {rel[0]:.3e}, "
              f"lam {rel[1]:.3e} > {QP_REL_TOL}")
    P, q, C, d = planar_hand_qps()
    (x_k, lam_k), (x_p, lam_p), rel = qp_gaps((P, q, C, d), 30)
    x_conv = cuda_qp.solve_qp_batched_plain(P, q, C, d, 120)
    torch.cuda.synchronize()
    scale = x_conv.abs().max().item() + 1e-9

    def p_rel(a, b, pct):
        return torch.quantile((a - b).abs().amax(1) / scale, pct).item()

    p90_k, p90_p = p_rel(x_k, x_conv, 0.9), p_rel(x_p, x_conv, 0.9)
    p50_agree = p_rel(x_k, x_p, 0.5)
    k2_err = max(k2_err, (x_k - x_p).abs().max().item())
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
    p90_w = p_rel(x_w, x_conv, 0.9)
    print(f"[K2] warm 6 it from (x, lam): p90 err vs converged {p90_w:.3e};"
          f" p50 kernel-plain {p_rel(x_w, x_wp, 0.5):.3e}; max rel err "
          f"kernel-plain x {rel_w[0]:.3e}, lam {rel_w[1]:.3e}")
    check(p90_w < max(2.5 * p90_k, 5e-2), f"K2 warm start: p90 {p90_w}")
    check(p_rel(x_w, x_wp, 0.5) < 2e-2, "K2 warm: bulk disagreement")
    check(max(rel_w) <= QP_WARM_REL_TOL,
          f"K2 warm start disagrees with the plain PDIP: rel err x "
          f"{rel_w[0]:.3e}, lam {rel_w[1]:.3e} > {QP_WARM_REL_TOL}")
    k2_times = {}
    timed = [("2048x30", (P, q, C, d), 30)] + [
        (f"{a[1].shape[0]}x{a[4]}", a[:4], a[4]) for a, _ in k2_calls]
    for label, args, iters in timed:
        k2_times[label] = (
            median_ms(lambda: cuda_qp.solve_qp_batched_cuda(*args, iters),
                      20),
            median_ms(lambda: cuda_qp.solve_qp_batched_plain(*args, iters),
                      5))
        print(f"[K2] {label}: kernel {k2_times[label][0]:.4f} ms, plain "
              f"{k2_times[label][1]:.3f} ms (median, CUDA events; {card})")

    # -- Phase 5: K3 against the plain factored ADMM loop --------------------
    k3_err = admm_errors(*k3_args, **k3_kw)
    prob_h, bounds_h, z0_h, y0_h = k3_args[:4]
    print(f"[K3] planar-hand first-iteration QP (T=30 n=11 m=4, u box, "
          f"12 sweeps, a=1.6): max abs err {k3_err:.3e}")
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
    k3_ms = median_ms(lambda: cuda_admm.solve_boxed_tvlqr_cuda(
        *k3_args, **k3_kw), 20)
    k3_plain_ms = median_ms(lambda: admm._admm_plain(
        prob_h, bounds_h, z0_h, y0_h, k3_kw["n_phys"], k3_kw["idx_w"],
        k3_kw["rho"], k3_kw["iters"], k3_kw["over_relax"]), 5)
    print(f"[K3] planar-hand QP: kernel {k3_ms:.4f} ms, plain loop "
          f"{k3_plain_ms:.3f} ms (median, CUDA events; {card})")
    # K1 on the same problem: the initial unconstrained solve of the ADMM.
    prob_k1 = lqr.LqrProblem(*(a.contiguous() for a in prob_h))
    K, k = cuda_riccati.riccati_backward_cuda(prob_k1)
    ref = lqr.riccati_backward_plain(prob_k1)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(K).all() and torch.isfinite(k).all()),
          "K1 planar hand: non-finite gains from the kernel")
    k1_rel = {label: ((got - want).abs().max() / want.abs().max()).item()
              for label, got, want in (("K", K, ref.K), ("k", k, ref.k))}
    k1_hand = (median_ms(lambda: cuda_riccati.riccati_backward_cuda(prob_k1),
                         20),
               median_ms(lambda: lqr.riccati_backward_plain(prob_k1), 5))
    print(f"[K1] planar-hand T=30 n=11 m=4 (N!=0): rel err K "
          f"{k1_rel['K']:.3e}, k {k1_rel['k']:.3e}; kernel {k1_hand[0]:.4f} "
          f"ms, plain loop {k1_hand[1]:.3f} ms (median, CUDA events; {card})")
    for label, err in k1_rel.items():
        check(err < REL_TOL,
              f"K1 planar hand: kernel {label} disagrees with the plain "
              f"loop: rel err {err:.3e} >= {REL_TOL}")

    # -- Phase 6: K4 against the plain lane-batched chain --------------------
    hand = k4_args[0]
    xs_k, us_k = cuda_rollout.linesearch_rollout_cuda(*k4_args)
    xs_p, us_p = rollout.linesearch_rollout_plain(*k4_args)
    torch.cuda.synchronize()
    check(tuple(xs_k.shape) == (6, HAND_T + 1, 7)
          and bool(torch.isfinite(xs_k).all()), "K4: bad trajectories")
    k4_err = max((xs_k - xs_p).abs().max().item(),
                 (us_k - us_p).abs().max().item())
    print(f"[K4] 6 lanes x T=30, first-iteration line search: max abs err "
          f"xs/us {k4_err:.3e}")
    check(k4_err < CHAIN_ATOL,
          f"K4 disagrees with the plain chain: {k4_err:.3e}")
    k4_ms = median_ms(lambda: cuda_rollout.linesearch_rollout_cuda(*k4_args),
                      20)
    k4_plain_ms = median_ms(
        lambda: rollout.linesearch_rollout_plain(*k4_args), 3)
    print(f"[K4] {hand.name}: kernel {k4_ms:.4f} ms, plain chain "
          f"{k4_plain_ms:.3f} ms (median, CUDA events; {card})")

    # -- Phase 7: the planar-hand slice on the card --------------------------
    for mod in KERNELS:
        mod.LAUNCHES = 0
    solver, _ = planar_hand_solver(DEVICE)
    solver.iterate(HAND_ITERATIONS, verbose=False)
    torch.cuda.synchronize()
    hand_launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                     for mod in KERNELS}
    curve = solver.cost_lst
    print("[hand] cost curve: " + " ".join(f"{c:.4f}" for c in curve))
    print(f"[hand] launches in {HAND_ITERATIONS} iterations: {hand_launches}")
    want = {"cuda_riccati": 1, "cuda_qp": 2, "cuda_admm": 1,
            "cuda_rollout": 1}
    for name, per_it in want.items():
        check(hand_launches[name] == per_it * HAND_ITERATIONS,
              f"{name}: {hand_launches[name]} launches in "
              f"{HAND_ITERATIONS} iterations, expected {per_it} each")
    check(abs(curve[0] - HAND_INITIAL) <= HAND_INITIAL_RTOL * HAND_INITIAL,
          f"planar hand: initial cost {curve[0]} is not {HAND_INITIAL} "
          f"within {HAND_INITIAL_RTOL:.1%}")
    check(abs(solver.cost_best - HAND_BEST) <= HAND_BEST_RTOL * HAND_BEST,
          f"planar hand: best cost {solver.cost_best} is not within "
          f"{HAND_BEST_RTOL:.0%} of {HAND_BEST}")
    tensors = ([solver.x_trj, solver.u_trj, solver.Q, solver.Qd, solver.R,
                solver.x0, solver.xd_trj, solver.x_trj_best,
                solver.u_trj_best] + solver.x_trj_lst + solver.u_trj_lst)
    check(all(_nvcc.on_card(t) for t in tensors),
          "a solver tensor is not on CUDA")
    check(tuple(solver.x_trj.shape) == (HAND_T + 1, 7)
          and tuple(solver.u_trj.shape) == (HAND_T, 4)
          and bool(torch.isfinite(solver.x_trj).all()
                   and torch.isfinite(solver.u_trj).all()),
          "planar hand: final trajectories wrong in shape or not finite")
    walls = [st.wall_time for st in solver.stats_lst]
    dt = statistics.median(walls[1:])
    print(f"[hand] first iteration {walls[0] * 1e3:.2f} ms; then median "
          f"{dt * 1e3:.3f} ms/iteration, {HAND_T * HAND_S / dt:.1f} contact "
          f"rollouts/s; best {solver.cost_best:.4f} ({card})")

    entries = [
        dict(name="riccati_backward", source="irs_mpc_torch/csrc/riccati.cu",
             replaces="irs_mpc_tpu/ops/pallas_riccati.py:46",
             launches=pend_launches + hand_launches["cuda_riccati"],
             launches_by_path={"pendulum": pend_launches,
                               "planar_hand": hand_launches["cuda_riccati"]},
             max_abs_err=results[0]["max_abs_err"], ms=results[0]["ms"],
             plain_ms=results[0]["plain_ms"]),
        dict(name="pdip_batched", source="irs_mpc_torch/csrc/pdip.cu",
             replaces="irs_mpc_tpu/models/contact/pallas_qp.py:33",
             launches=hand_launches["cuda_qp"], max_abs_err=k2_err,
             ms=k2_times["1500x15"][0], plain_ms=k2_times["1500x15"][1]),
        dict(name="admm_boxed", source="irs_mpc_torch/csrc/admm.cu",
             replaces="irs_mpc_tpu/ops/pallas_admm.py:53",
             launches=hand_launches["cuda_admm"], max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms),
        dict(name="rollout_chain", source="irs_mpc_torch/csrc/rollout.cu",
             replaces="irs_mpc_tpu/models/contact/pallas_rollout.py:613",
             launches=hand_launches["cuda_rollout"], max_abs_err=k4_err,
             ms=k4_ms, plain_ms=k4_plain_ms),
    ]
    print(json.dumps({"kernels": [dict(route="cuda", **e) for e in entries]}))
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
