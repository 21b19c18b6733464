#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``irs_mpc_torch``) on one GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which passes or ends the run with a non-zero
exit code:

0. environment: torch, CUDA, nvcc and the card; fails without a CUDA device;
1. builds the Riccati kernel (K1) from ``irs_mpc_torch/csrc/riccati.cu``;
2. holds K1 against the plain PyTorch loop on the card at three problems
   (pendulum T=200 n=2 m=1; a T=200 n=16 m=4 random problem; a Δu problem
   with a cross term) and times both;
3. drives the pendulum iRS-MPC slice (T=200, 1000 samples per knot,
   zero-order, 9 iterations) on the card and holds it to the reference
   cost curve: initial 1856.1541, final and best <= 360, one K1 launch per
   iteration.

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from irs_mpc_torch import IrsMpc, IrsMpcParams, SmoothingConfig, make_pendulum
from irs_mpc_torch.ops import cuda_riccati, lqr

REL_TOL = 1e-3          # max|ΔK| / max|K| and the same for k
INITIAL_COST = 1856.1541
INITIAL_TOL = 0.01
FINAL_COST_MAX = 360.0
T, NUM_SAMPLES, ITERATIONS = 200, 1000, 9


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
    dev = "cuda"
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


def bench_problem():
    """The random T=200, n=16, m=4 tracking problem, made from numpy seed 1
    by the construction of the JAX package's Riccati benchmark."""
    n, m = 16, 4
    rng = np.random.RandomState(1)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    A = f(np.eye(n)[None] + 0.05 * rng.randn(T, n, n))
    B = f(0.3 * rng.randn(T, n, m))
    c = f(0.05 * rng.randn(T, n))
    x0 = f(rng.randn(n))
    return lqr.build_tracking_problem(
        A, B, c, f(np.eye(n)), f(10.0 * np.eye(n)), f(np.eye(m)), x0,
        f(np.zeros((T + 1, n))))


def main():
    # -- Phase 0: environment ------------------------------------------------
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    nvcc = cuda_riccati.nvcc_path()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout
    print(f"nvcc {nvcc}: {nvcc_version.strip().splitlines()[-1]}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}  (torch: {kind}, {torch.cuda.device_count()} "
          f"device(s))")

    # -- Phase 1: build K1 ---------------------------------------------------
    t0 = time.perf_counter()
    lib = cuda_riccati.build()
    print(f"[build] {lib.name}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_riccati.build_seconds:.2f} s)")
    for line in cuda_riccati.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build] {line.strip()}")

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
    solver = IrsMpc(make_pendulum(0.05), params, device="cuda")
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
    check(all(t.is_cuda for t in tensors), "a solver tensor is not on CUDA")
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

    pend_result = results[0]
    print(json.dumps({"kernels": [{
        "name": "riccati_backward",
        "route": "cuda",
        "source": "irs_mpc_torch/csrc/riccati.cu",
        "replaces": "irs_mpc_tpu/ops/pallas_riccati.py:46",
        "launches": launches,
        "max_abs_err": pend_result["max_abs_err"],
        "ms": pend_result["ms"],
        "plain_ms": pend_result["plain_ms"],
    }]}))
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
