"""Checkpoint and resume of an iRS-MPC or CEM solve.

The port of ``irs_mpc_tpu/utils/checkpoint.py``, with the same payload but
for the random state: the JAX package saves its PRNG key, the port the
state of the solver's ``torch.Generator`` (``generator.get_state()``, a
uint8 array).  An ``IrsMpc`` resumed from a checkpoint draws the same
samples as the uninterrupted run and reproduces it exactly.

Like the JAX module it saves no CEM sampling state beyond the mean
trajectory: neither ``std_trj`` nor the persisted elites (``kept``).  A
resumed CEM restarts from its initial std, so its curve is not the
uninterrupted one, in either package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def save_checkpoint(path, solver) -> Path:
    """Snapshot an IrsMpc (or CEM) solver's resumable state to an .npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def host(t):
        return t.detach().cpu().numpy()

    np.savez(path,
             u_trj=host(solver.u_trj),
             x_trj=host(solver.x_trj),
             generator=solver.generator.get_state().numpy(),
             iteration=np.asarray(solver.iter),
             cost_lst=np.asarray(solver.cost_lst),
             cost_best=np.asarray(solver.cost_best),
             u_trj_best=host(solver.u_trj_best),
             x_trj_best=host(solver.x_trj_best))
    return path


def load_checkpoint(path, solver) -> None:
    """Restore a solver's state in place, its tensors on the solver's own
    device; continue with ``iterate``."""
    with np.load(path) as data:
        def dev(name):
            return torch.as_tensor(data[name]).to(solver.device)

        solver.u_trj = dev("u_trj")
        solver.x_trj = dev("x_trj")
        solver.generator.set_state(torch.as_tensor(data["generator"]))
        solver.iter = int(data["iteration"])
        solver.cost_lst = [float(c) for c in data["cost_lst"]]
        solver.cost = solver.cost_lst[-1]
        solver.cost_best = float(data["cost_best"])
        solver.u_trj_best = dev("u_trj_best")
        solver.x_trj_best = dev("x_trj_best")
