"""Carry problems, parameters and solver state from the JAX package over.

The JAX objects are read duck-typed, through ``getattr`` and
``np.asarray``; this module imports nothing of JAX.  The slice has no
learned weights: what crosses is the problem and the solver's iterate.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.estimators import SmoothingConfig, inv_sqrt_decay
from .ops.lqr import LqrProblem
from .solvers.irs_mpc import IrsMpc, IrsMpcParams, IterationStats


def _tensor(a, device, dtype=torch.float32):
    """A copy of ``a`` (JAX arrays convert to read-only numpy views)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def problem_from_numpy(A, B, c, Q, R, N, q, r, Qf, qf, x0,
                       device="cpu") -> LqrProblem:
    """An f32 ``LqrProblem`` on ``device`` from array-likes in field order
    (so ``problem_from_numpy(*jax_problem)`` works)."""
    return LqrProblem(*(_tensor(a, device)
                        for a in (A, B, c, Q, R, N, q, r, Qf, qf, x0)))


def _is_default_decay(decay) -> bool:
    """The port's default, or the JAX package's: the lambda in the body of
    its ``SmoothingConfig`` that gives 1/sqrt(it)."""
    if decay is inv_sqrt_decay:
        return True
    if getattr(decay, "__qualname__", None) != "SmoothingConfig.<lambda>":
        return False
    its = np.arange(1, 65, dtype=np.float32)
    return np.allclose(np.asarray(decay(its), np.float64),
                       1.0 / np.sqrt(its.astype(np.float64)), rtol=1e-6)


def params_from_jax(p, device="cpu") -> IrsMpcParams:
    """A torch ``IrsMpcParams`` on ``device`` from a JAX ``IrsMpcParams``.

    Raises if the smoothing decay is not the default 1/sqrt(it) (a closure
    cannot be carried across) or if a mesh, an estimation system or an
    iteration callback is set.  The JAX Riccati backends ("scan", "pallas",
    "auto") all become the port's "auto"; "assoc" stays and is refused by
    the solver until it is ported."""
    for name in ("mesh", "estimation_system", "iteration_callback"):
        if getattr(p, name, None) is not None:
            raise ValueError(f"params_from_jax: {name} cannot be carried "
                             "across")
    sm = p.smoothing
    if not _is_default_decay(sm.decay):
        raise ValueError("params_from_jax: only the default 1/sqrt(it) "
                         "variance decay can be carried across")

    def std(v):
        a = np.asarray(v, np.float32)
        return float(a) if a.ndim == 0 else _tensor(a, device)

    def opt(a, dtype=torch.float32):
        return None if a is None else _tensor(a, device, dtype)

    smoothing = SmoothingConfig(
        num_samples=int(sm.num_samples), std_x=std(sm.std_x),
        std_u=std(sm.std_u), damp=float(sm.damp),
        decay_std_x=bool(sm.decay_std_x),
        zero_order_B_A_source=str(sm.zero_order_B_A_source))
    return IrsMpcParams(
        Q=_tensor(p.Q, device), Qd=_tensor(p.Qd, device),
        R=_tensor(p.R, device), x0=_tensor(p.x0, device),
        xd_trj=_tensor(p.xd_trj, device),
        u_trj_init=_tensor(p.u_trj_init, device),
        x_bounds_abs=opt(p.x_bounds_abs), u_bounds_abs=opt(p.u_bounds_abs),
        x_bounds_rel=opt(p.x_bounds_rel), u_bounds_rel=opt(p.u_bounds_rel),
        bounds_trust_region=bool(p.bounds_trust_region),
        indices_u_into_x=opt(p.indices_u_into_x, torch.long),
        unactuated_indices=opt(p.unactuated_indices, torch.long),
        gradient_mode=str(p.gradient_mode),
        smoothing=smoothing,
        decouple_AB=bool(p.decouple_AB),
        forward_mode=str(p.forward_mode),
        line_search_alphas=tuple(float(a) for a in p.line_search_alphas),
        parallel_riccati=bool(p.parallel_riccati),
        riccati_backend=("assoc" if p.riccati_backend == "assoc"
                         else "auto"),
        admm_iters=int(p.admm_iters), admm_rho=float(p.admm_rho),
        admm_over_relax=float(p.admm_over_relax),
        seed=int(p.seed),
        report_final_cost_with_Q=bool(p.report_final_cost_with_Q))


def state_from_jax(src, dst: IrsMpc) -> IrsMpc:
    """Load a JAX ``IrsMpc``'s iterate into the torch solver ``dst``:
    ``x_trj``, ``u_trj``, ``iter``, ``cost``, the best-so-far and the
    history, so that ``dst`` continues from where ``src`` stands.  The
    random streams of the two differ and are not carried."""
    dev = dst.device
    dst.x_trj = _tensor(src.x_trj, dev)
    dst.u_trj = _tensor(src.u_trj, dev)
    dst.iter = int(src.iter)
    dst.cost = float(src.cost)
    dst.cost_best = float(src.cost_best)
    dst.x_trj_best = _tensor(src.x_trj_best, dev)
    dst.u_trj_best = _tensor(src.u_trj_best, dev)
    dst.x_trj_lst = [_tensor(x, dev) for x in src.x_trj_lst]
    dst.u_trj_lst = [_tensor(u, dev) for u in src.u_trj_lst]
    dst.cost_lst = [float(c) for c in src.cost_lst]
    dst.stats_lst = [IterationStats(**{
        f: float(getattr(s, f)) for f in IterationStats.__dataclass_fields__})
        for s in src.stats_lst]
    return dst
