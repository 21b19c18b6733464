"""Host side of kernel K3, the whole boxed-ADMM sweep loop in CUDA C++.

``solve_boxed_tvlqr_cuda`` adds the sweep-invariant quadratic penalties of
the enabled bound kinds to Q, R, N and Qf (``admm._penalized_quadratics``),
allocates the kernel's scratch (the knots' operands where they do not fit
in shared memory, and z, z_prev, y per enabled kind) and launches
``csrc/admm.cu`` on PyTorch's current stream, or raises; there is no
fallback.  The plain version is the factored loop of ``admm._admm_plain``;
``admm.solve_boxed_tvlqr`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import timing
from . import admm as admm_ops
from ._nvcc import KernelLibrary, check_tensors, stream_of

MAX_N = 64
MAX_M = 16

# Kernel launches made by solve_boxed_tvlqr_cuda.
LAUNCHES = 0

_P4 = ctypes.c_void_p * 4
_I4 = ctypes.c_int * 4


def _bind(lib):
    lib.admm_boxed_f32.argtypes = (
        [ctypes.c_void_p] * 16 + [_P4] * 5 + [_I4] + [ctypes.c_int] * 5
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.admm_boxed_f32.restype = ctypes.c_int
    for fn in (lib.admm_staged, lib.admm_ops_floats):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int


LIB = KernelLibrary("admm.cu", _bind, "admm_error_string")


_placements: dict = {}


def placement(T: int, n: int, m: int) -> str:
    """Where the kernel keeps the knots' operands of a (T, n, m) problem on
    the current CUDA device: "shared" (staged in shared memory once) or
    "streamed" (global scratch, each chain prefetching the next knot)."""
    key = (T, n, m, torch.cuda.current_device())
    if key not in _placements:
        staged = LIB.load().admm_staged(T, n, m)
        if staged < 0:
            raise ValueError(f"the ADMM kernel takes n <= {MAX_N}, m <= "
                             f"{MAX_M}; got T={T}, n={n}, m={m}, or the "
                             f"device query failed")
        _placements[key] = "shared" if staged else "streamed"
    return _placements[key]


def solve_boxed_tvlqr_cuda(prob, bounds, z0, y0, n_phys: int, idx_w,
                           rho: float, iters: int, over_relax: float):
    """Launch K3 on ``prob`` (an unpenalised ``LqrProblem`` of f32 CUDA
    tensors), ``bounds`` (``admm.BoxBounds``) and the initial consensus and
    dual values ``z0``/``y0`` (``admm._SVals``, enabled kinds only).
    Returns (x (T+1,n), u (T,m), K (T,m,n), k (T,m), z, z_prev) with z and
    z_prev ``_SVals`` of the enabled kinds.  Raises on CPU tensors, other
    dtypes or shapes, n > 64, m > 16, and a du box whose prev-input block
    is not ``x[n_phys:]``."""
    global LAUNCHES
    T, n, m = prob.B.shape
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_M and 1 <= n_phys <= n):
        raise ValueError(f"the ADMM kernel takes n <= {MAX_N}, m <= {MAX_M},"
                         f" 1 <= n_phys <= n; got n={n}, m={m}, "
                         f"n_phys={n_phys}")
    dims = {"x": (T + 1, n_phys), "u": (T, m), "dx": (T, n_phys),
            "du": (T, m)}
    shapes = {"A": (prob.A, (T, n, n)), "B": (prob.B, (T, n, m)),
              "c": (prob.c, (T, n)), "Q": (prob.Q, (T, n, n)),
              "R": (prob.R, (T, m, m)), "N": (prob.N, (T, n, m)),
              "q": (prob.q, (T, n)), "r": (prob.r, (T, m)),
              "Qf": (prob.Qf, (n, n)), "qf": (prob.qf, (n,)),
              "x0": (prob.x0, (n,))}
    kinds = [kd for kd in admm_ops.KINDS if getattr(bounds, kd) is not None]
    for kd in kinds:
        shapes[f"bounds.{kd}"] = (getattr(bounds, kd), (2,) + dims[kd])
        shapes[f"z0.{kd}"] = (getattr(z0, kd), dims[kd])
        shapes[f"y0.{kd}"] = (getattr(y0, kd), dims[kd])
    if bounds.du is not None:
        want = torch.arange(n_phys, n)
        with timing.span("sync"):           # idx_w's copy to the host
            fits = (n - n_phys == m and idx_w is not None
                    and torch.equal(idx_w.cpu(), want))
        if not fits:
            raise ValueError("the ADMM kernel takes a du box only with the "
                             "prev-input block at x[n_phys:] (idx_w = "
                             "arange(n_phys, n))")
    device = check_tensors("the ADMM kernel", shapes, contiguous=False)

    Q, R, N, Qf = admm_ops._penalized_quadratics(prob, bounds, rho, n_phys,
                                                 idx_w)
    ins = [a.expand(shape).contiguous() for a, shape in (
        (prob.A, (T, n, n)), (prob.B, (T, n, m)), (prob.c, (T, n)),
        (Q, (T, n, n)), (R, (T, m, m)), (N, (T, n, m)), (prob.q, (T, n)),
        (prob.r, (T, m)), (Qf, (n, n)), (prob.qf, (n,)), (prob.x0, (n,)))]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    lib = LIB.load()
    with torch.cuda.device(device):
        streamed = placement(T, n, m) == "streamed"
    # The knots' operands go to a global scratch only where they do not fit
    # in shared memory.
    ops = empty(lib.admm_ops_floats(T, n, m)) if streamed else None
    x, u, K, k = empty(T + 1, n), empty(T, m), empty(T, m, n), empty(T, m)
    lb, ub, z, zp, y = {}, {}, {}, {}, {}
    for kd in kinds:
        b = getattr(bounds, kd)
        lb[kd], ub[kd] = b[0].contiguous(), b[1].contiguous()
        z[kd] = getattr(z0, kd).contiguous().clone()
        y[kd] = getattr(y0, kd).contiguous().clone()
        zp[kd] = torch.empty_like(z[kd])

    def ptrs(d):
        return _P4(*[d[kd].data_ptr() if kd in d else None
                     for kd in admm_ops.KINDS])

    with torch.cuda.device(device):
        err = lib.admm_boxed_f32(
            *[None if a is None else a.data_ptr()
              for a in ins + [ops, x, u, K, k]],
            ptrs(lb), ptrs(ub), ptrs(z), ptrs(zp), ptrs(y),
            _I4(*[int(kd in kinds) for kd in admm_ops.KINDS]),
            T, n, m, n_phys, int(iters), float(rho), float(over_relax),
            int(not streamed), stream_of(device))
    LIB.check(err, "ADMM kernel")
    LAUNCHES += 1
    return x, u, K, k, admm_ops._SVals(**z), admm_ops._SVals(**zp)
