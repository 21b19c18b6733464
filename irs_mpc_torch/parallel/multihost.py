"""Multi-process start-up for sharded estimation.

The counterpart of the JAX package's ``parallel/multihost.py``.  Every
process runs the same program; ``initialize`` joins them into one
``torch.distributed`` group (NCCL on the card, gloo on the CPU) and
``pod_mesh`` lays a (sample, knot) mesh over the cells of every rank:

    from irs_mpc_torch.parallel import multihost
    multihost.initialize("tcp://host:port", world_size=2, rank=r)
    params.mesh = multihost.pod_mesh(knot_shards=2)

Nothing tells a program of a cluster: the address, the world size and the
rank are the caller's, or the launcher's ``env://`` variables.  With
neither, a single process runs alone and ``initialize`` does nothing.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .sharded import Mesh

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (a no-op if it is already up, or when no
    ``init_method`` is given and the launcher set no ``env://``
    variables).  ``backend`` defaults to NCCL where CUDA is available,
    else gloo.  Failing to reach an explicit ``init_method`` raises."""
    if dist.is_initialized():
        return
    explicit = init_method is not None
    if not explicit:
        if not all(k in os.environ for k in _ENV):
            return                      # one process, no address: alone
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=-1 if world_size is None
                                else world_size,
                                rank=-1 if rank is None else rank)
    except (ValueError, RuntimeError):
        if explicit:
            raise
        return
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def pod_mesh(knot_shards: int = 1,
             local_devices: Optional[Sequence] = None) -> Mesh:
    """The (sample, knot) mesh over the cells of every rank of the group:
    each rank brings ``local_devices`` (default: its CUDA devices, or the
    CPU without one), in rank order, so that the sample axis, which every
    estimate reduces over, runs within a rank first.  Outside a group the
    mesh holds this process's cells alone."""
    if local_devices is None:
        count = torch.cuda.device_count()
        local_devices = ([f"cuda:{i}" for i in range(count)] if count
                         else ["cpu"])
    local = [torch.device(d) for d in local_devices]
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    n = world * len(local)
    if n % knot_shards:
        raise ValueError(f"{n} cells not divisible by {knot_shards} knot "
                         f"shards")
    return Mesh(devices=tuple(local) * world,
                ranks=tuple(r for r in range(world) for _ in local),
                n_sample=n // knot_shards, n_knot=knot_shards,
                distributed=up)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
