"""Where K1's, K2's, K3's and K4's time goes on the card, phase by phase.

    python3 -m irs_mpc_torch.tools.probe_chains

from the repository root, on a machine with an NVIDIA GPU and the CUDA
toolkit.  For the first iteration of the box-pushing, planar-hand and
box-pivoting slices (the solvers of ``irs_mpc_torch/examples/``) it prints

- each kernel's device time (``torch.profiler``, mean of 10 launches)
  against its iteration count: K4 at 0, 1, 5 and 10 warm PDIP iterations a
  knot, K3 at 0, 1, 10 and 30 sweeps, K2 (both calls of the estimation
  sweep) at 0, 1, 10 and 30 PDIP iterations; K1's with and without its
  plan (the ADMM's initial solve), from launches queued back to back
  (``k1_queued_ms``);
- K1's device time with its plan at each thread count a block could have
  at the widths the slices use (NB = 8: box pushing and pivoting; NB =
  16: the planar hand and the T = 200, n = 16 bench problem), from copies
  of ``csrc/riccati.cu`` whose ``chain_threads`` is changed for that width;
- the SM cycles of each phase of one launch, read with ``clock64()`` by
  thread 0 of block 0 of an instrumented copy of ``csrc/rollout.cu``,
  ``csrc/admm.cu``, ``csrc/pdip.cu`` and ``csrc/riccati.cu`` (its chain
  kernel, n <= 16): timers go in before the phase comments of the source
  (the copy is built into ``irs_mpc_torch/_build/``; the kernels the port
  runs are never instrumented).

The instrumented copies read the phase comments as anchors and stop if one
is missing.
"""
import ctypes
import dataclasses
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..examples import box_pivoting, box_pushing, planar_hand
from ..models.contact import cuda_qp, cuda_rollout
from ..ops import _nvcc, cuda_admm, cuda_riccati, lqr
from ..utils.timing import card_line
from .kernel_inputs import bench_problem, first_iteration_inputs

GETTER = '''
extern "C" void prof_read(unsigned long long* h) {
  cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));
}
extern "C" void prof_reset() {
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''


def mark(i, who):
    return (f"if ({who}) {{ unsigned long long _c = clock64(); "
            f"g_prof[{i}] += _c - _t; _t = _c; }}\n")


# (anchor in the source, phase that ends there); the first entry starts the
# clock.
K4_PHASES = [
    ("  for (int t = 0; t < T; ++t) {\n", None),
    ("    // -- assembly: b, and two", "feedback"),
    ("    // -- warm start from", "assembly"),
    ("    for (int it = 0; it < iters; ++it) {\n", "warm start"),
    ("      // The tableau [diag(pdiag)", "mu, rows (and the last update)"),
    ("      // Gauss-Jordan, no pivoting", "tableau"),
    ("      // dx, the last column, into every thread.", "Gauss-Jordan"),
    ("    // -- carry: dq, cleaned", "last update"),
    ("  }\n}\n\n}  // namespace", "carry"),
]
K3_PHASES = [
    ("  // ---- 1. factorisation and the closed-loop operands", None),
    ("  // z_prev starts at z0.", "factorisation"),
    ("    // (b) the backward chain on warp 0.", "(a) linear terms"),
    ("    // (c) k += HB (Pc + p_{t+1}) ...", "(b) backward chain"),
    ("    // (d) the rollout chain on warp 0.", "(c) k and e"),
    ("    // (e) u = -(K x + k), and x out", "(d) rollout chain"),
    ("    // ... then the over-relaxed consensus", "(e) u, x"),
    ("  }\n}\n\n// Opts in to", "(e) consensus"),
]

K2_PHASES = [
    ("  // -- stage the QP's C, P and q --", None),
    ("  float x[NA], xk[NA];", "staging, rows"),
    ("    // -- mu, and per row", "start (cold solve, slacks)"),
    ("    // -- the tableau [P + C'WC", "mu, rows"),
    ("    gauss_jordan<NA, G>(col, mask);   // col = dx", "tableau"),
    ("    // -- the step: fraction", "Gauss-Jordan"),
    ("  }\n\n  if (live) {", "step"),
]
K1_PHASES = [
    ("  // ---- the backward pass", None),
    ("    // Phase 1: PA = P A, PB", "knot start (copies, wait, barrier)"),
    ("    // Phase 2: tableau rows", "PA, PB, Pc + p"),
    ("    // Phase 3: Gauss-Jordan", "tableau"),
    ("    const float* X = src + MB;", "Gauss-Jordan"),
    ("  }\n\n  // ---- the linear plan", "P, p, K, k"),
    ("  }\n}\n\n// The compile-time widths", "plan"),
]


def instrumented(lib, phases, who):
    """Build a copy of ``lib``'s source with a clock64 timer at each
    anchor; returns (ctypes library, phase names)."""
    s = lib.source.read_text()
    s = s.replace("namespace {\n",
                  "namespace {\n__device__ unsigned long long g_prof[16];\n",
                  1)
    names = []
    for anchor, name in phases:
        if anchor not in s:
            raise RuntimeError(f"{lib.source.name}: no anchor {anchor!r}")
        code = ("  unsigned long long _t = clock64();\n" if name is None
                else mark(len(names), who))
        if name is not None:
            names.append(name)
        s = s.replace(anchor, code + anchor, 1)
    src = _nvcc.BUILD_DIR / f"{lib.source.stem}_probe.cu"
    out = _nvcc.BUILD_DIR / f"lib{lib.source.stem}_probe.so"
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(s + GETTER)
    subprocess.run([_nvcc.nvcc_path(), *_nvcc.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(out))
    so.prof_read.argtypes = [ctypes.c_void_p]
    return so, names


def device_ms(fn, reps=10):
    """Mean device time of the kernel launched by ``fn`` (the largest
    device event by time)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tot[ev.name] = tot.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return max(tot.values()) / 1e3 / reps


THREADS_LINE = ("  return nb <= 4 ? 32 : nb == 8 ? 64 : nb == 16 ? 128 : "
                "256;")


def riccati_variants(variants):
    """Copies of K1's source with ``threads`` threads at width ``nb`` for
    each (nb, threads) of ``variants``, built together (one nvcc each) and
    loaded; returns {(nb, threads): library}."""
    lib = cuda_riccati.LIB
    s = lib.source.read_text()
    if THREADS_LINE not in s:
        raise RuntimeError(f"{lib.source.name}: no anchor {THREADS_LINE!r}")
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for nb, threads in variants:
        src = _nvcc.BUILD_DIR / f"riccati_nb{nb}_t{threads}.cu"
        out = _nvcc.BUILD_DIR / f"libriccati_nb{nb}_t{threads}.so"
        src.write_text(s.replace(THREADS_LINE,
                                 f"  return nb == {nb} ? {threads} : "
                                 f"({THREADS_LINE[9:-1]});"))
        jobs[nb, threads] = (out, subprocess.Popen(
            [_nvcc.nvcc_path(), *_nvcc.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    libs = {}
    for key, (out, proc) in jobs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed building the K1 variant {key}")
        so = ctypes.CDLL(str(out))
        cuda_riccati._bind(so)
        fn = so.riccati_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        libs[key] = so
    return libs


def k1_queued_ms(prob, plan=True, reps=50):
    """K1's device time a launch, from CUDA events around ``reps`` launches
    queued back to back through the C function (outputs allocated once, no
    Python checks between them, so the device and not the host sets the
    pace).  ``torch.profiler`` drops events after many profiles in one
    process; this does not depend on it."""
    lib = cuda_riccati.LIB.load()
    T, n, m = prob.B.shape
    dev = prob.A.device
    outs = [torch.empty(s, device=dev) for s in ((T, m, n), (T, m),
                                                  (T + 1, n), (T, m))]
    if not plan:
        outs[2:] = [None, None]
    ptrs = [getattr(prob, f).data_ptr() for f in cuda_riccati._FIELDS]
    ptrs += [prob.x0.data_ptr() if plan else None]
    ptrs += [None if a is None else a.data_ptr() for a in outs]
    staged = int(cuda_riccati.placement(T, n, m) == "shared")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.riccati_solve_f32(*ptrs, T, n, m, staged, stream)
        if err:
            raise RuntimeError(f"K1 launch failed ({err})")

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_cycles(so, names, fn):
    torch.cuda.synchronize()
    so.prof_reset()
    fn()
    torch.cuda.synchronize()
    h = (ctypes.c_ulonglong * 16)()
    so.prof_read(h)
    total = sum(h[:len(names)])
    print("    " + "; ".join(f"{nm} {h[i]}" for i, nm in enumerate(names))
          + f"; total {total} cycles")


def main():
    card = card_line()
    print(card)
    _nvcc.build_all([cuda_admm.LIB, cuda_rollout.LIB, cuda_qp.LIB,
                     cuda_riccati.LIB])
    inputs = {name: first_iteration_inputs(mod.build_solver)
              for name, mod in (("box_pushing", box_pushing),
                                ("planar_hand", planar_hand),
                                ("box_pivoting", box_pivoting))}
    for name, (k2, (k3a, k3k), (k4a, _)) in inputs.items():
        for args, _ in k2:
            B = args[1].shape[0]
            for it in (0, 1, 10, 30):
                ms = device_ms(
                    lambda: cuda_qp.solve_qp_batched_cuda(*args[:4], it))
                print(f"[probe] {name} K2, {B} QPs, {it} PDIP iterations: "
                      f"device {ms:.4f} ms ({card})")
        prob = lqr.LqrProblem(*(a.contiguous() for a in k3a[0]))
        for label, plan in (("with", True), ("without", False)):
            ms = k1_queued_ms(prob, plan)
            print(f"[probe] {name} K1 {label} the plan, T, n, m = "
                  f"{tuple(prob.B.shape)}: device {ms:.4f} ms, queued "
                  f"({card})")
        model = k4a[0]
        for it in (0, 1, 5, 10):
            m2 = dataclasses.replace(model, qp_iters_ws=it)
            ms = device_ms(
                lambda: cuda_rollout.linesearch_rollout_cuda(m2, *k4a[1:]))
            print(f"[probe] {name} K4, {it} PDIP iterations a knot: device "
                  f"{ms:.4f} ms ({card})")
        for sweeps in (0, 1, 10, 30):
            kw = dict(k3k, iters=sweeps)
            ms = device_ms(
                lambda: cuda_admm.solve_boxed_tvlqr_cuda(*k3a, **kw))
            print(f"[probe] {name} K3, {sweeps} sweeps: device {ms:.4f} ms "
                  f"({card})")
    problems = {name: lqr.LqrProblem(*(a.contiguous() for a in k3a[0]))
                for name, (_, (k3a, _), _) in inputs.items()}
    problems["bench"] = lqr.LqrProblem(*(a.contiguous()
                                         for a in bench_problem()))
    built = cuda_riccati.LIB.load()
    variants = riccati_variants([(8, 32), (8, 64), (8, 128), (16, 32),
                                 (16, 128), (16, 256)])
    for (nb, threads), so in variants.items():
        cuda_riccati.LIB._lib = so
        for name, prob in problems.items():
            if (8 if prob.B.shape[1] <= 8 else 16) != nb:
                continue
            ms = k1_queued_ms(prob)
            print(f"[probe] {name} K1 with the plan at width {nb} on "
                  f"{threads} threads, T, n, m = {tuple(prob.B.shape)}: "
                  f"device {ms:.4f} ms, queued ({card})")
    cuda_riccati.LIB._lib = built
    so, names = instrumented(cuda_rollout.LIB, K4_PHASES,
                             "blockIdx.x == 0 && threadIdx.x == 0")
    cuda_rollout._bind(so)
    cuda_rollout.LIB._lib = so
    for name, (_, _, (k4a, _)) in inputs.items():
        print(f"[probe] {name} K4 cycles by phase, lane 0 of the first "
              f"line-search lane ({card}):")
        phase_cycles(so, names,
                     lambda: cuda_rollout.linesearch_rollout_cuda(*k4a))
    so, names = instrumented(cuda_admm.LIB, K3_PHASES, "threadIdx.x == 0")
    cuda_admm._bind(so)
    cuda_admm.LIB._lib = so
    for name, (_, (k3a, k3k), _) in inputs.items():
        print(f"[probe] {name} K3 cycles by phase, thread 0 ({card}):")
        phase_cycles(so, names,
                     lambda: cuda_admm.solve_boxed_tvlqr_cuda(*k3a, **k3k))
    so, names = instrumented(cuda_qp.LIB, K2_PHASES,
                             "blockIdx.x == 0 && threadIdx.x == 0")
    cuda_qp._bind(so)
    cuda_qp.LIB._lib = so
    for name, (k2, _, _) in inputs.items():
        for args, _ in k2:
            print(f"[probe] {name} K2 cycles by phase, {args[1].shape[0]} "
                  f"QPs x {args[4]} it, lane 0 of the first QP ({card}):")
            phase_cycles(so, names, lambda: cuda_qp.solve_qp_batched_cuda(
                *args[:4], args[4]))
    so, names = instrumented(cuda_riccati.LIB, K1_PHASES, "threadIdx.x == 0")
    cuda_riccati._bind(so)
    cuda_riccati.LIB._lib = so
    for name, (_, (k3a, _), _) in inputs.items():
        prob = lqr.LqrProblem(*(a.contiguous() for a in k3a[0]))
        print(f"[probe] {name} K1 with the plan, cycles by phase, thread 0, "
              f"T, n, m = {tuple(prob.B.shape)} ({card}):")
        phase_cycles(so, names, lambda: cuda_riccati.lqr_solve_cuda(prob))
    print("[probe] SM clock, max: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout)


if __name__ == "__main__":
    main()
