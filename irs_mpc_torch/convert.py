"""Carry models, problems, parameters and solver state from the JAX
package over.

The JAX objects are read duck-typed, through ``getattr``, ``np.asarray``
and their class names; this module imports nothing of JAX.  What crosses is
the model description, the problem, the solver's iterate and the weights of
a learned MLP (``mlp_from_flax``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.bicycle import make_bicycle
from .models.contact import geometry as geom
from .models.contact.mbp2d import Mbp2DModel
from .models.contact.quasistatic import (ContactPair, ModelInstance,
                                         QuasistaticModel)
from .models.mlp import DynamicsMlp
from .models.pendulum import make_pendulum
from .models.quadrotor import make_quadrotor
from .models.three_cart import make_three_cart
from .ops.estimators import SmoothingConfig, inv_sqrt_decay
from .ops.lqr import LqrProblem
from .solvers.cem import CemParams
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


def _plain(v):
    """A dataclass field value as plain Python: tuples of floats/ints."""
    if isinstance(v, (tuple, list)) or hasattr(v, "__array__"):
        a = np.asarray(v)
        if a.ndim == 0:
            return a.item()
        return tuple(x.item() if hasattr(x, "item") else x for x in a)
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def _carry(obj, cls):
    """``cls`` built from the same-named fields of the dataclass ``obj``."""
    return cls(**{f.name: _plain(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


_SHAPES = {c.__name__: c for c in (geom.Circle, geom.Capsule, geom.Box,
                                   geom.HalfSpace)}
_BODIES = {c.__name__: c for c in (geom.StaticBody, geom.FreeBody2D,
                                   geom.Arm2D, geom.PrismaticFinger2D)}


def model_from_jax(m) -> QuasistaticModel:
    """A torch ``QuasistaticModel`` from a JAX one: its bodies, shapes,
    pairs and model instances carried dataclass to dataclass, as Python
    values.  Raises on a body or shape kind the port does not have."""
    def body(b):
        kind = type(b).__name__
        if kind not in _BODIES:
            raise TypeError(f"model_from_jax: no body kind {kind}")
        cls = _BODIES[kind]
        fields = {f.name: _plain(getattr(b, f.name))
                  for f in dataclasses.fields(cls) if f.name != "shapes"}
        if hasattr(b, "shapes") and "shapes" in {
                f.name for f in dataclasses.fields(cls)}:
            shapes = []
            for s in b.shapes:
                if type(s).__name__ not in _SHAPES:
                    raise TypeError(f"model_from_jax: no shape kind "
                                    f"{type(s).__name__}")
                shapes.append(_carry(s, _SHAPES[type(s).__name__]))
            fields["shapes"] = tuple(shapes)
        return cls(**fields)

    return QuasistaticModel(
        name=m.name, h=float(m.h), nq=int(m.nq),
        models=tuple(_carry(mi, ModelInstance) for mi in m.models),
        bodies=tuple(body(b) for b in m.bodies),
        pairs=tuple(_carry(pr, ContactPair) for pr in m.pairs),
        gravity=_plain(m.gravity), qp_iters=int(m.qp_iters),
        qp_iters_ws=int(m.qp_iters_ws), contact_model=str(m.contact_model),
        canon_warm_duals=bool(m.canon_warm_duals))


_ANALYTIC = {"pendulum": make_pendulum, "bicycle": make_bicycle,
             "quadrotor": make_quadrotor, "three_cart": make_three_cart}


def system_from_jax(s):
    """The port's counterpart of a JAX system: a quasistatic contact model
    (``model_from_jax``), a second-order contact model (``Mbp2DModel``: its
    base through ``model_from_jax``, and its own fields), or an analytic
    system by its name, with the constructor arguments of the JAX factory:
    its ``h``, and the cart width ``d`` of the three-cart model, read from
    the closure of its step.  Raises on a name the port has no factory
    for."""
    if type(s).__name__ == "QuasistaticModel":
        return model_from_jax(s)
    if type(s).__name__ == "Mbp2DModel":
        return Mbp2DModel(
            base=model_from_jax(s.base), actuated_mass=_plain(
                s.actuated_mass), damping=float(s.damping),
            control_mode=str(s.control_mode), kd_ratio=float(s.kd_ratio))
    if s.name not in _ANALYTIC:
        raise ValueError(f"system_from_jax: no analytic factory "
                         f"{s.name!r}")
    step = s.step
    free = dict(zip(step.__code__.co_freevars,
                    (c.cell_contents for c in step.__closure__ or ())))
    kw = {"d": float(free["d"])} if s.name == "three_cart" else {}
    return _ANALYTIC[s.name](h=float(s.h), **kw)


def mlp_from_flax(params, hidden, dim_x: int, device="cpu") -> DynamicsMlp:
    """A ``DynamicsMlp`` on ``device`` with the weights of the JAX
    package's flax MLP: ``params`` as ``model.init`` returns them
    ({"params": {"Dense_i": {"kernel": (in, out), "bias": (out,)}}}); each
    kernel is transposed into its ``Linear``'s (out, in) weight."""
    dense = params["params"]
    dim_u = np.asarray(dense["Dense_0"]["kernel"]).shape[0] - dim_x
    model = DynamicsMlp(tuple(hidden), dim_x, dim_u, device=device)
    with torch.no_grad():
        for i, layer in enumerate(list(model.hidden) + [model.out]):
            d = dense[f"Dense_{i}"]
            layer.weight.copy_(_tensor(np.asarray(d["kernel"]).T, device))
            layer.bias.copy_(_tensor(d["bias"], device))
    return model


def cem_params_from_jax(p) -> CemParams:
    """A torch ``CemParams`` from a JAX one: arrays as numpy copies, the
    solver puts them on its device."""
    def arr(v):
        return None if v is None else np.array(v)

    return CemParams(**{
        f.name: (arr(getattr(p, f.name)) if f.name in (
            "Q", "Qd", "R", "x0", "xd_trj", "u_trj_init", "initial_std",
            "indices_u_into_x", "u_bounds_abs", "std_floor")
            else _plain(getattr(p, f.name)))
        for f in dataclasses.fields(CemParams)})


def params_from_jax(p, device="cpu", decay=None,
                    estimation_system=None) -> IrsMpcParams:
    """A torch ``IrsMpcParams`` on ``device`` from a JAX ``IrsMpcParams``.

    A closure cannot be carried across: a smoothing decay other than the
    default 1/sqrt(it) needs its torch counterpart as ``decay``, and a JAX
    ``estimation_system`` needs the torch one as ``estimation_system``
    (e.g. ``model.estimation_surrogate()`` of the carried model).  Raises
    where either is missing, and if a mesh or an iteration callback is
    set.  The JAX Riccati backends ("scan", "pallas", "auto") all become
    the port's "auto"; "assoc" stays."""
    for name in ("mesh", "iteration_callback"):
        if getattr(p, name, None) is not None:
            raise ValueError(f"params_from_jax: {name} cannot be carried "
                             "across")
    if p.estimation_system is not None and estimation_system is None:
        raise ValueError("params_from_jax: the estimation_system cannot be "
                         "carried across; pass its torch counterpart")
    sm = p.smoothing
    if decay is None:
        if not _is_default_decay(sm.decay):
            raise ValueError("params_from_jax: only the default 1/sqrt(it) "
                             "variance decay can be carried across; pass "
                             "the torch decay")
        decay = inv_sqrt_decay

    def std(v):
        a = np.asarray(v, np.float32)
        return float(a) if a.ndim == 0 else _tensor(a, device)

    def opt(a, dtype=torch.float32):
        return None if a is None else _tensor(a, device, dtype)

    smoothing = SmoothingConfig(
        num_samples=int(sm.num_samples), std_x=std(sm.std_x),
        std_u=std(sm.std_u), decay=decay, damp=float(sm.damp),
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
        estimation_system=estimation_system,
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
