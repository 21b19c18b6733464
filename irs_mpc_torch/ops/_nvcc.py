"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel source in ``irs_mpc_torch/csrc/`` is compiled for ``sm_90a`` into
a shared library with a plain C interface, at first use, into
``irs_mpc_torch/_build/`` under a name keyed by a hash of the source and the
flags (written to a temporary file, then renamed, so a half-written library
is never loaded).  Nothing is built or loaded when a module is imported.

``build_all`` starts one nvcc for each library that is not built yet, all
together, and waits for them: the sources are independent, and nvcc for a
file with a plain C interface takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The nvcc of the CUDA toolkit PyTorch finds; raises if there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit for building the "
                           "kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


class KernelLibrary:
    """One source of ``csrc/`` and the library built from it.

    ``bind(lib)`` sets the argument and result types of the library's C
    functions; ``error_fn`` names its function that maps a CUDA error code
    to its message.  ``log`` (nvcc's ptxas report of registers, shared
    memory and spills) and ``seconds`` are empty until this process
    builds."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None],
                 error_fn: str):
        self.source = CSRC / source
        self._bind = bind
        self._error_fn = error_fn
        self._lib = None
        self.log = ""
        self.seconds = 0.0

    def path(self) -> Path:
        """Where the build for the current source and flags goes."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile unless a build of the same source and flags exists;
        returns the library's path.  Raises if nvcc fails."""
        return build_all([self])[0]

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            fn = getattr(lib, self._error_fn)
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code other than 0."""
        if err != 0:
            msg = getattr(self._lib, self._error_fn)(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def build_all(libs) -> list[Path]:
    """Build every library of ``libs`` that is not built yet, one nvcc
    each, all started together; returns their paths in order."""
    outs = [lib.path() for lib in libs]
    jobs = []
    for lib, out in zip(libs, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR)
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(lib.source)],
            stdout=log, stderr=subprocess.STDOUT, text=True)
        jobs.append((lib, out, tmp, proc, log, time.perf_counter()))
    failures = []
    pending = list(jobs)
    while pending:
        # Poll, so that each library's seconds are its own nvcc's.
        time.sleep(0.05)
        for job in [j for j in pending if j[3].poll() is not None]:
            pending.remove(job)
            lib, out, tmp, proc, log, t0 = job
            lib.seconds = time.perf_counter() - t0
            log.seek(0)
            lib.log = log.read()
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failures.append(f"nvcc failed building {lib.source.name}:\n"
                                f"{lib.log}")
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def on_card(t) -> bool:
    """The device rule of every kernel wrapper: True for a CUDA tensor,
    which goes to the hand-written kernel; a CPU tensor goes to the plain
    PyTorch version."""
    return t.device.type == "cuda"


def check_tensors(what: str, tensors: dict, contiguous: bool = True,
                  device_type: str = "cuda"):
    """Raise ValueError unless every entry ``name: (tensor, shape)`` of
    ``tensors`` is an f32 tensor of that shape on one device of
    ``device_type`` (and contiguous, where the kernel reads it as it lies);
    returns the device.  Only the CPU emulation of the kernels
    (``tools.cpu_shim``) asks for "cpu"."""
    device = None
    for name, (a, shape) in tensors.items():
        if a.dtype is not torch.float32:
            raise ValueError(f"{what}: {name} is {a.dtype}, the kernel "
                             "takes float32")
        if a.shape != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")
        if contiguous and not a.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        d = a.device
        if device is None:
            device = d
        elif d != device:
            raise ValueError(f"{what}: {name} is on {d}, the others "
                             f"on {device}")
    if device is None or device.type != device_type:
        raise ValueError(f"{what} needs {device_type.upper()} tensors, got "
                         f"{device}")
    return device


def stream_of(device) -> int:
    """PyTorch's current stream on ``device``, as the pointer a kernel's
    C function takes."""
    return torch.cuda.current_stream(device).cuda_stream
