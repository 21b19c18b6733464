"""Host side of kernel K4, the whole line-searched contact rollout chain.

``linesearch_rollout_cuda`` flattens the model into the pair table of
``rollout.make_consts`` (cached per model and device; each pair's first
row and contact count included, every arm's links in a table of their
own) and launches ``csrc/rollout.cu``, one warp
per line-search lane, on PyTorch's current stream, or raises; there is no
fallback.  The kernel makes the input bounds finite as
``rollout.bound_rows`` does.  It is the contact model's ``ls_rollout_fn``,
which the solver calls for CUDA tensors only.  The plain version is
``rollout.linesearch_rollout_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from ...ops._nvcc import KernelLibrary, check_tensors, stream_of
from . import rollout

MAX_NZ = 32

# Kernel launches made by linesearch_rollout_cuda.
LAUNCHES = 0

_consts_cache: dict = {}


def _bind(lib):
    lib.rollout_chain_f32.argtypes = ([ctypes.c_void_p] * 20
                                      + [ctypes.c_int] * 10
                                      + [ctypes.c_void_p])
    lib.rollout_chain_f32.restype = ctypes.c_int


LIB = KernelLibrary("rollout.cu", _bind, "rollout_error_string")


def _consts(model, device):
    key = (model, str(device))
    if key not in _consts_cache:
        _consts_cache[key] = rollout.make_consts(model, device)
    return _consts_cache[key]


def linesearch_rollout_cuda(model, x0, u_prev0, K, z_ref_x, z_ref_w, u_ref,
                            lb, ub, rel_lb, rel_ub):
    """Launch K4.  Shapes as ``rollout.linesearch_rollout_plain``; every
    tensor f32 on one CUDA device.  Raises on anything else, and on a model
    that ``rollout.supports_model`` refuses: a pair kind the narrow phase
    does not have, or more than ``rollout.MAX_ROWS`` rows, counted two for
    each contact."""
    global LAUNCHES
    if not rollout.supports_model(model):
        raise ValueError(f"the rollout kernel does not take model "
                         f"{model.name!r} (see rollout.supports_model)")
    A, T, m = u_ref.shape
    nq = model.nq
    nz = K.shape[-1]
    if m != model.dim_u or nz > MAX_NZ:
        raise ValueError(f"the rollout kernel takes m = {model.dim_u} and "
                         f"nz <= {MAX_NZ}; got m={m}, nz={nz}")
    if nz != (nq + m if z_ref_w is not None else nq):
        raise ValueError(f"K has {nz} columns; the rollout kernel takes "
                         f"nq + m with z_ref_w, nq without")
    shapes = {"x0": (x0, (nq,)), "u_prev0": (u_prev0, (m,)),
              "K": (K, (T, m, nz)), "z_ref_x": (z_ref_x, (A, T, nq)),
              "u_ref": (u_ref, (A, T, m)), "lb": (lb, (T, m)),
              "ub": (ub, (T, m))}
    if z_ref_w is not None:
        shapes["z_ref_w"] = (z_ref_w, (A, T, m))
    if (rel_lb is None) != (rel_ub is None):
        raise ValueError("the rollout kernel takes both rel bounds or none")
    if rel_lb is not None:
        shapes["rel_lb"] = (rel_lb, (T, m))
        shapes["rel_ub"] = (rel_ub, (T, m))
    device = check_tensors("the rollout kernel", shapes, contiguous=False)

    c = _consts(model, device)
    ins = [None if a is None else a.contiguous()
           for a in (K, z_ref_x, z_ref_w, u_ref, lb, ub, rel_lb, rel_ub, x0,
                     u_prev0)]
    ins += [c["pdiag"], c["pq"], c["KUT"], c["tau"], c["pair_i"],
            c["pair_f"], c["link_i"], c["link_f"]]
    xs = torch.empty((A, T + 1, nq), dtype=torch.float32, device=device)
    us = torch.empty((A, T, m), dtype=torch.float32, device=device)
    ptrs = [0 if a is None else a.data_ptr() for a in ins + [xs, us]]
    lib = LIB.load()
    with torch.cuda.device(device):
        err = lib.rollout_chain_f32(
            *ptrs, A, T, nq, m, nz, len(model.pairs), len(c["link_i"]),
            c["rows"],
            int(model.qp_iters_ws), int(model.canon_warm_duals),
            stream_of(device))
    LIB.check(err, "rollout kernel")
    LAUNCHES += 1
    return xs, us
