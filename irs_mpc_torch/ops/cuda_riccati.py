"""Host side of kernel K1, the whole Riccati backward pass in CUDA C++, and
the linear plan after it.

The kernel (``csrc/riccati.cu``) is built and loaded by ``_nvcc`` at first
use; nothing is built or loaded when this module is imported.

``riccati_backward_cuda`` launches the backward pass alone (K, k);
``lqr_solve_cuda`` launches it with the plan rolled out from ``prob.x0`` in
the same launch (x, u, K, k).  Both run on PyTorch's current stream or
raise; there is no fallback.  The plain versions of the same computations
are ``lqr.riccati_backward_plain`` and ``lqr.lqr_rollout_linear`` after
it; ``lqr.riccati_backward`` and ``lqr.lqr_solve`` pick by the tensors'
device.
"""
from __future__ import annotations

import ctypes

import torch

from ._nvcc import KernelLibrary, check_tensors, stream_of

MAX_N = 64
MAX_M = 16

# Kernel launches made by riccati_backward_cuda and lqr_solve_cuda, for
# checking that a run went through the kernel.
LAUNCHES = 0

_FIELDS = ("A", "B", "c", "Q", "R", "N", "q", "r", "Qf", "qf")


def _bind(lib):
    lib.riccati_solve_f32.argtypes = ([ctypes.c_void_p] * 15
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
    lib.riccati_solve_f32.restype = ctypes.c_int
    lib.riccati_staged.argtypes = [ctypes.c_int] * 3
    lib.riccati_staged.restype = ctypes.c_int


LIB = KernelLibrary("riccati.cu", _bind, "riccati_error_string")

_placements: dict = {}


def placement(T: int, n: int, m: int) -> str:
    """Where the kernel keeps the knots' operands of a (T, n, m) problem on
    the current CUDA device: "shared" (all T knots copied in before the
    chain) or "streamed" (each knot copied into a two-slot ring while the
    one before it computes)."""
    key = (T, n, m, torch.cuda.current_device())
    if key not in _placements:
        staged = LIB.load().riccati_staged(T, n, m)
        if staged < 0:
            raise ValueError(f"the Riccati kernel takes n <= {MAX_N}, m <= "
                             f"{MAX_M}; got T={T}, n={n}, m={m}, or the "
                             f"device query failed")
        _placements[key] = "shared" if staged else "streamed"
    return _placements[key]


def _check(prob, plan):
    T, n, m = prob.B.shape
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_M and T >= 1):
        raise ValueError(f"the Riccati kernel takes T >= 1, n <= {MAX_N}, "
                         f"m <= {MAX_M}; got T={T}, n={n}, m={m}")
    shapes = {"A": (T, n, n), "B": (T, n, m), "c": (T, n), "Q": (T, n, n),
              "R": (T, m, m), "N": (T, n, m), "q": (T, n), "r": (T, m),
              "Qf": (n, n), "qf": (n,), "x0": (n,)}
    fields = _FIELDS + (("x0",) if plan else ())
    device = check_tensors("the Riccati kernel",
                           {f: (getattr(prob, f), shapes[f]) for f in fields})
    return T, n, m, device


def _launch(prob, plan: bool):
    global LAUNCHES
    T, n, m, device = _check(prob, plan)
    lib = LIB.load()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    K, k = empty(T, m, n), empty(T, m)
    x, u = (empty(T + 1, n), empty(T, m)) if plan else (None, None)
    with torch.cuda.device(device):
        staged = placement(T, n, m) == "shared"
        ptrs = [getattr(prob, f).data_ptr() for f in _FIELDS]
        ptrs += [prob.x0.data_ptr() if plan else None]
        ptrs += [None if a is None else a.data_ptr() for a in (K, k, x, u)]
        err = lib.riccati_solve_f32(*ptrs, T, n, m, int(staged),
                                    stream_of(device))
    LIB.check(err, "Riccati kernel")
    LAUNCHES += 1
    return x, u, K, k


def riccati_backward_cuda(prob):
    """Launch K1 on ``prob`` (an ``LqrProblem`` of contiguous f32 CUDA
    tensors).  Returns (K (T,m,n), k (T,m)); raises on anything else."""
    return _launch(prob, plan=False)[2:]


def lqr_solve_cuda(prob):
    """Launch K1 with the linear plan from ``prob.x0``: one launch for the
    backward pass and the rollout of the linear model under the gains.
    Returns (x (T+1,n), u (T,m), K (T,m,n), k (T,m)); raises on anything
    but contiguous f32 CUDA tensors."""
    return _launch(prob, plan=True)
