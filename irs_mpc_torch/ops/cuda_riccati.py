"""Host side of kernel K1, the whole Riccati backward pass in CUDA C++.

The kernel (``csrc/riccati.cu``) is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``irs_mpc_torch/_build/`` under a name keyed by a hash of the source and
the flags, and loaded with ``ctypes``.  Nothing is built or loaded when this
module is imported.

``riccati_backward_cuda`` launches the kernel on PyTorch's current stream or
raises; there is no fallback.  The plain version of the same computation is
``lqr.riccati_backward_plain``; ``lqr.riccati_backward`` picks between the
two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

MAX_N = 64
MAX_M = 16

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "riccati.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches made by riccati_backward_cuda, for checking that a run
# went through the kernel.
LAUNCHES = 0

_lib = None
# What the last build printed (nvcc's ptxas register and shared-memory
# report) and how long it took; empty until this process builds.
build_log = ""
build_seconds = 0.0

_FIELDS = ("A", "B", "c", "Q", "R", "N", "q", "r", "Qf", "qf")


def nvcc_path() -> str:
    """The nvcc of the CUDA toolkit PyTorch finds; raises if there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit for building the "
                           "Riccati kernel")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path() -> Path:
    """Where the build for the current source and flags goes."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libriccati_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel unless a build of the same source and flags
    exists; returns the library's path.  Raises if nvcc fails."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = res.stdout + res.stderr
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.riccati_backward_f32
        fn.argtypes = ([ctypes.c_void_p] * 12
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.riccati_error_string.argtypes = [ctypes.c_int]
        lib.riccati_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(prob):
    T, n, m = prob.B.shape
    shapes = {"A": (T, n, n), "B": (T, n, m), "c": (T, n), "Q": (T, n, n),
              "R": (T, m, m), "N": (T, n, m), "q": (T, n), "r": (T, m),
              "Qf": (n, n), "qf": (n,)}
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_M and T >= 1):
        raise ValueError(f"the Riccati kernel takes T >= 1, n <= {MAX_N}, "
                         f"m <= {MAX_M}; got T={T}, n={n}, m={m}")
    device = prob.A.device
    for name in _FIELDS:
        a = getattr(prob, name)
        if a.dtype != torch.float32:
            raise ValueError(f"{name} is {a.dtype}, the kernel takes float32")
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shapes[name]}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, A on {device}")
    if device.type != "cuda":
        raise ValueError(
            f"the Riccati kernel needs CUDA tensors, got {device}")
    return T, n, m, device


def riccati_backward_cuda(prob):
    """Launch K1 on ``prob`` (an ``LqrProblem`` of contiguous f32 CUDA
    tensors).  Returns (K (T,m,n), k (T,m)); raises on anything else."""
    global LAUNCHES
    T, n, m, device = _check(prob)
    lib = _load()
    K = torch.empty((T, m, n), dtype=torch.float32, device=device)
    k = torch.empty((T, m), dtype=torch.float32, device=device)
    ptrs = [getattr(prob, f).data_ptr() for f in _FIELDS]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.riccati_backward_f32(*ptrs, K.data_ptr(), k.data_ptr(),
                                       T, n, m, stream)
    if err != 0:
        msg = lib.riccati_error_string(err).decode()
        raise RuntimeError(f"Riccati kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return K, k
