"""Host side of kernel K1, the whole Riccati backward pass in CUDA C++.

The kernel (``csrc/riccati.cu``) is built and loaded by ``_nvcc`` at first
use; nothing is built or loaded when this module is imported.

``riccati_backward_cuda`` launches the kernel on PyTorch's current stream or
raises; there is no fallback.  The plain version of the same computation is
``lqr.riccati_backward_plain``; ``lqr.riccati_backward`` picks between the
two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from ._nvcc import KernelLibrary, check_tensors, stream_of

MAX_N = 64
MAX_M = 16

# Kernel launches made by riccati_backward_cuda, for checking that a run
# went through the kernel.
LAUNCHES = 0

_FIELDS = ("A", "B", "c", "Q", "R", "N", "q", "r", "Qf", "qf")


def _bind(lib):
    lib.riccati_backward_f32.argtypes = ([ctypes.c_void_p] * 12
                                         + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p])
    lib.riccati_backward_f32.restype = ctypes.c_int


LIB = KernelLibrary("riccati.cu", _bind, "riccati_error_string")


def _check(prob):
    T, n, m = prob.B.shape
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_M and T >= 1):
        raise ValueError(f"the Riccati kernel takes T >= 1, n <= {MAX_N}, "
                         f"m <= {MAX_M}; got T={T}, n={n}, m={m}")
    shapes = {"A": (T, n, n), "B": (T, n, m), "c": (T, n), "Q": (T, n, n),
              "R": (T, m, m), "N": (T, n, m), "q": (T, n), "r": (T, m),
              "Qf": (n, n), "qf": (n,)}
    device = check_tensors("the Riccati kernel",
                           {f: (getattr(prob, f), shapes[f]) for f in _FIELDS})
    return T, n, m, device


def riccati_backward_cuda(prob):
    """Launch K1 on ``prob`` (an ``LqrProblem`` of contiguous f32 CUDA
    tensors).  Returns (K (T,m,n), k (T,m)); raises on anything else."""
    global LAUNCHES
    T, n, m, device = _check(prob)
    lib = LIB.load()
    K = torch.empty((T, m, n), dtype=torch.float32, device=device)
    k = torch.empty((T, m), dtype=torch.float32, device=device)
    ptrs = [getattr(prob, f).data_ptr() for f in _FIELDS]
    with torch.cuda.device(device):
        err = lib.riccati_backward_f32(*ptrs, K.data_ptr(), k.data_ptr(),
                                       T, n, m, stream_of(device))
    LIB.check(err, "Riccati kernel")
    LAUNCHES += 1
    return K, k
