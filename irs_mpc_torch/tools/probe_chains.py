"""Where K3's and K4's time goes on the card, phase by phase.

    python3 -m irs_mpc_torch.tools.probe_chains

from the repository root, on a machine with an NVIDIA GPU and the CUDA
toolkit.  For the first iteration of the box-pushing, planar-hand and
box-pivoting slices (``chip_smoke``'s solvers) it prints

- each kernel's device time (``torch.profiler``, mean of 10 launches)
  against its iteration count: K4 at 0, 1, 5 and 10 warm PDIP iterations a
  knot, K3 at 0, 1, 10 and 30 sweeps;
- the SM cycles of each phase of one launch, read with ``clock64()`` by
  thread 0 of block 0 of an instrumented copy of ``csrc/rollout.cu`` and
  ``csrc/admm.cu``: timers go in before the phase comments of the source
  (the copy is built into ``irs_mpc_torch/_build/``; the kernels the port
  runs are never instrumented).

The instrumented copies read the phase comments as anchors and stop if one
is missing.
"""
import ctypes
import dataclasses
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from irs_mpc_torch.models.contact import cuda_rollout  # noqa: E402
from irs_mpc_torch.ops import _nvcc, cuda_admm  # noqa: E402

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
    card = cs.card_line()
    print(card)
    _nvcc.build_all([cuda_admm.LIB, cuda_rollout.LIB])
    inputs = {name: cs.first_iteration_inputs(fn)[1:] for name, fn in (
        ("box_pushing", cs.box_pushing_solver),
        ("planar_hand", cs.planar_hand_solver),
        ("box_pivoting", cs.box_pivoting_solver))}
    for name, ((k3a, k3k), (k4a, _)) in inputs.items():
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
    so, names = instrumented(cuda_rollout.LIB, K4_PHASES,
                             "blockIdx.x == 0 && threadIdx.x == 0")
    cuda_rollout._bind(so)
    cuda_rollout.LIB._lib = so
    for name, (_, (k4a, _)) in inputs.items():
        print(f"[probe] {name} K4 cycles by phase, lane 0 of the first "
              f"line-search lane ({card}):")
        phase_cycles(so, names,
                     lambda: cuda_rollout.linesearch_rollout_cuda(*k4a))
    so, names = instrumented(cuda_admm.LIB, K3_PHASES, "threadIdx.x == 0")
    cuda_admm._bind(so)
    cuda_admm.LIB._lib = so
    for name, ((k3a, k3k), _) in inputs.items():
        print(f"[probe] {name} K3 cycles by phase, thread 0 ({card}):")
        phase_cycles(so, names,
                     lambda: cuda_admm.solve_boxed_tvlqr_cuda(*k3a, **k3k))
    print("[probe] SM clock, max: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout)


if __name__ == "__main__":
    main()
