"""Host side of kernel K2: B independent dense QPs by batched PDIP.

``solve_qp_batched`` solves min 1/2 x'Px + q'x s.t. Cx <= d for P (B,n,n),
q (B,n), C (B,m,n), d (B,m) by the fixed-iteration primal-dual interior
point method of ``qp._pdip_solve``, optionally warm-started from
``init=(x0 (B,n), lam0 (B,m))`` and optionally returning the final duals
(``want_lam``).  CUDA tensors launch the kernel (``csrc/pdip.cu``, a tile
of 8, 16 or 32 lanes per QP, ``lanes``) and raise if it cannot run; CPU
tensors run the plain version, ``_pdip_solve`` over the batch.

The kernel reads the inputs batch-first as the caller holds them and
writes x and the duals in the same layout; an input that is not
contiguous is copied once (the main path's are contiguous).
"""
from __future__ import annotations

import ctypes

import torch

from ...ops import _nvcc
from ...ops._nvcc import KernelLibrary, check_tensors, stream_of
from .qp import _pdip_solve

MAX_N = 16
MAX_M = 64

# Kernel launches made from the host by solve_qp_batched_cuda; one
# recorded into a CUDA graph is not counted (its replays launch it).
LAUNCHES = 0


def _bind(lib):
    lib.pdip_solve_f32.argtypes = ([ctypes.c_void_p] * 8
                                   + [ctypes.c_int] * 4 + [ctypes.c_float]
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.pdip_solve_f32.restype = ctypes.c_int
    lib.pdip_lanes.argtypes = [ctypes.c_int] * 2
    lib.pdip_lanes.restype = ctypes.c_int


LIB = KernelLibrary("pdip.cu", _bind, "pdip_error_string")


def lanes(n: int, m: int) -> int:
    """The lanes of the kernel's tile for one (n, m) QP (32 for the generic
    instance, fewer for a model's compile-time one)."""
    return LIB.load().pdip_lanes(n, m)


def solve_qp_batched_plain(P, q, C, d, iters: int = 30, sigma: float = 0.25,
                           init=None, want_lam: bool = False):
    """The plain version: ``_pdip_solve`` over the leading batch."""
    x, _, lam = _pdip_solve(P, q, C, d, iters, sigma, init)
    return (x, lam) if want_lam else x


def solve_qp_batched(P, q, C, d, iters: int = 30, sigma: float = 0.25,
                     init=None, want_lam: bool = False):
    """B QPs by the tensors' device; returns x (B,n), or (x, lam (B,m))
    with ``want_lam``."""
    if _nvcc.on_card(q):
        return solve_qp_batched_cuda(P, q, C, d, iters, sigma, init,
                                     want_lam)
    if q.device.type == "cpu":
        return solve_qp_batched_plain(P, q, C, d, iters, sigma, init,
                                      want_lam)
    raise ValueError(f"no batched QP solve for device {q.device}")


def solve_qp_batched_cuda(P, q, C, d, iters: int = 30, sigma: float = 0.25,
                          init=None, want_lam: bool = False):
    """Launch K2 on f32 CUDA tensors; raises on anything else and on
    n > 16 or m > 64."""
    global LAUNCHES
    if q.dim() != 2 or d.dim() != 2:
        raise ValueError("the batched QP kernel takes q (B,n) and d (B,m)")
    B, n = q.shape
    m = d.shape[1]
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_M and B >= 1 and iters >= 0):
        raise ValueError(f"the batched QP kernel takes n <= {MAX_N}, "
                         f"m <= {MAX_M}, B >= 1, iters >= 0; got B={B}, "
                         f"n={n}, m={m}, iters={iters}")
    shapes = {"P": (P, (B, n, n)), "q": (q, (B, n)), "C": (C, (B, m, n)),
              "d": (d, (B, m))}
    if init is not None:
        shapes["x0"] = (init[0], (B, n))
        shapes["lam0"] = (init[1], (B, m))
    device = check_tensors("the batched QP kernel", shapes, contiguous=False)

    ins = [a.contiguous() for a in (P, q, C, d)]
    ins += ([a.contiguous() for a in init] if init is not None
            else [None, None])
    x = torch.empty((B, n), dtype=torch.float32, device=device)
    lam = (torch.empty((B, m), dtype=torch.float32, device=device)
           if want_lam else None)
    ptrs = [0 if a is None else a.data_ptr() for a in ins + [x, lam]]
    lib = LIB.load()
    with torch.cuda.device(device):
        err = lib.pdip_solve_f32(*ptrs, B, n, m, int(iters), float(sigma),
                                 int(init is not None), int(want_lam),
                                 stream_of(device))
    LIB.check(err, "batched QP kernel")
    if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        LAUNCHES += 1
    return (x, lam) if want_lam else x
