"""Run the port's CUDA kernel sources on the CPU, for checking them where
there is no GPU and no nvcc.

``build_all(sources, out_dir)`` rewrites each ``csrc/*.cu`` for
``cpu_shim.h`` (kernel launches become ``shim_launch`` calls, dynamic
shared memory a buffer) and compiles it with g++ into a shared library,
one g++ process per source, all started together.  ``attached(module,
lib)`` points a kernel wrapper (``ops.cuda_riccati``, ``ops.cuda_admm``,
``models.contact.cuda_qp``, ``models.contact.cuda_rollout``) at such a
library for CPU tensors while
the context lasts, so that the wrapper, the kernel's source and the plain
version can be compared as the card tests compare them.  Each CUDA thread
is an OS thread, so a block of 256 threads is slow: keep the shapes small.
Extra flags such as ``-fsanitize=thread`` or ``-fsanitize=address`` (with
the sanitizer's runtime preloaded into Python) check the source's barriers
and bounds.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import re
import subprocess
from pathlib import Path

import torch

from ..ops import _nvcc

HEADER = Path(__file__).with_name("cpu_shim.h")


def translate(source: str) -> str:
    """The CUDA source as C++ for ``cpu_shim.h``."""
    source = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                    r"\1* \2 = (\1*)shim_dyn_smem();", source)
    return re.sub(
        r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);",
        lambda mt: (f"shim_launch({mt.group(2)}, [&] {{ "
                    f"{mt.group(1)}({mt.group(3)}); }});"),
        source, flags=re.S)


def build_all(sources, out_dir, flags=()) -> list:
    """Compile each ``.cu`` of ``sources`` for the shim into ``out_dir``;
    returns the loaded libraries in order.  Raises if g++ fails."""
    out_dir = Path(out_dir)
    # The CUDA headers the sources include are empty here.
    for name in ("cuda_runtime.h", "cuda_pipeline.h"):
        (out_dir / name).write_text("")
    jobs = []
    for src in map(Path, sources):
        cpp = out_dir / f"{src.stem}_shim.cpp"
        cpp.write_text(translate(src.read_text()))
        so = out_dir / f"lib{src.stem}_shim.so"
        jobs.append((so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
             "-I", str(out_dir), "-include", str(HEADER), *flags,
             "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"g++ failed building {so.name}:\n{log}")
        libs.append(ctypes.CDLL(str(so)))
    return libs


def set_smem_cap(lib, nbytes: int) -> None:
    """The opt-in shared memory the emulated device reports."""
    ctypes.c_int.in_dll(lib, "shim_smem_cap").value = nbytes


@contextlib.contextmanager
def attached(module, lib):
    """While the context lasts, ``module``'s wrapper launches ``lib``'s
    emulation on CPU tensors (its checks otherwise unchanged)."""
    saved = (module.LIB._lib, module.check_tensors, module.stream_of,
             torch.cuda.device, torch.cuda.current_device)
    module._bind(lib)
    err = getattr(lib, module.LIB._error_fn)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    module.LIB._lib = lib
    module.check_tensors = functools.partial(_nvcc.check_tensors,
                                             device_type="cpu")
    module.stream_of = lambda device: 0
    torch.cuda.device = lambda device: contextlib.nullcontext()
    torch.cuda.current_device = lambda: -1
    try:
        yield
    finally:
        (module.LIB._lib, module.check_tensors, module.stream_of,
         torch.cuda.device, torch.cuda.current_device) = saved
