"""Smoothed time-varying linearisation estimators.

Every knot's samples are one flat (T*S) batch through the system's batched
step or Jacobian; least-squares fits go through normal-equation moments,
batched over knots.  Modes (the reference's ``gradient_mode`` strings):

  * "exact"          - A, B from the exact Jacobian.
  * "first_order"    - average of Jacobians at perturbed points.
  * "zero_order"     - sample (dx, du), fit [A|B] jointly.
  * "zero_order_B"   - sample du only; B from least squares, A from the
                       exact Jacobian (or first-order averaging).
  * "zero_order_AB"  - sample (dx, du), damped least squares for both.

On float32 CUDA tensors the zero-order modes' fused sweep (a system's
``est_sweep_fn``) runs after the draws (and zero_order_B's A, where it is
needed) as one CUDA graph replay: the sweep, the fits and c are captured
once for each sweep function, mode and shape (``SWEEP_GRAPHS``) and
replayed every call, in place of some hundreds of small launches from the
host.  Every other call runs eagerly.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable, NamedTuple, Optional

import torch

from ..models.base import System
from ..utils import timing
from . import _nvcc
from .linalg import solve_spd

Tensor = torch.Tensor

GRADIENT_MODES = ("exact", "first_order", "zero_order", "zero_order_B",
                  "zero_order_AB")


class TvLinearization(NamedTuple):
    """Time-varying affine model x_{t+1} ≈ A_t x_t + B_t u_t + c_t."""
    A: Tensor  # (T, n, n)
    B: Tensor  # (T, n, m)
    c: Tensor  # (T, n)


def inv_sqrt_decay(it: Tensor) -> Tensor:
    """The default variance-decay schedule 1/sqrt(it); ``it`` is 1-based,
    so iteration 1 draws at full std."""
    return 1.0 / torch.sqrt(it)


@dataclasses.dataclass(frozen=True, eq=False)
class SmoothingConfig:
    """Monte-Carlo smoothing configuration.

    ``std_x``/``std_u`` are base standard deviations (scalars or per-dim
    arrays); ``decay(it)`` maps the iteration count, an f32 scalar tensor, to
    a multiplicative scale."""
    num_samples: int = 100
    std_x: object = 1e-3
    std_u: object = 0.1
    decay: Callable[[Tensor], Tensor] = inv_sqrt_decay
    damp: float = 1e-2          # Tikhonov damping for zero_order_AB
    decay_std_x: bool = True    # whether decay applies to std_x as well
    zero_order_B_A_source: str = "exact"    # "exact" | "first_order"

    def stds(self, it, dim_x: int, dim_u: int, device=None):
        """Per-dim (std_x, std_u) at iteration ``it``, f32 on ``device``.

        The scale is computed on the host in f32; a scalar std is filled on
        the device, so neither copies from the host (an array std does,
        unless it already is a tensor on ``device``)."""
        scale = float(self.decay(torch.tensor(float(it),
                                              dtype=torch.float32)))

        def vec(v, dim):
            if isinstance(v, (int, float)):
                return torch.full((dim,), float(v), dtype=torch.float32,
                                  device=device)
            v = torch.as_tensor(v, dtype=torch.float32, device=device)
            return v.expand(dim)

        sx = vec(self.std_x, dim_x)
        if self.decay_std_x:
            sx = sx * scale
        return sx, vec(self.std_u, dim_u) * scale


def _fit_lstsq(S: Tensor, D: Tensor, damp: float = 0.0) -> Tensor:
    """Least-squares fit D ≈ S @ Theta via normal equations, batched.

    S: (..., B, p) regressors, D: (..., B, n) targets; returns Theta' of
    shape (..., n, p), the [A|B] layout.  Damping adds damp^2 I to the Gram
    matrix."""
    p = S.shape[-1]
    eye = torch.eye(p, dtype=S.dtype, device=S.device)
    St = S.transpose(-1, -2)
    G = St @ S + (damp * damp) * eye
    M = St @ D
    # Tiny ridge for rank-deficient unregularised fits.
    eps = 1e-9 * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / p + 1e-12
    theta = solve_spd(G + eps[..., None, None] * eye, M)
    return theta.transpose(-1, -2)


def fit_from_moments(G: Tensor, M: Tensor, damp: float = 0.0) -> Tensor:
    """Solve the normal equations from pre-reduced moments G (..., p, p),
    M (..., p, n); returns (..., n, p)."""
    p = G.shape[-1]
    eye = torch.eye(p, dtype=G.dtype, device=G.device)
    Gd = G + (damp * damp) * eye
    eps = 1e-9 * torch.diagonal(Gd, dim1=-2, dim2=-1).sum(-1) / p + 1e-12
    return solve_spd(Gd + eps[..., None, None] * eye, M).transpose(-1, -2)


def _flat(fn, *args_ts):
    """Call a batched operator on (T, S, ...) inputs as one (T*S) batch."""
    T, S = args_ts[0].shape[:2]
    out = fn(*(a.reshape((T * S,) + a.shape[2:]) for a in args_ts))
    return out.reshape((T, S) + out.shape[1:])


def draw_perturbations(generator: torch.Generator, sx: Tensor, su: Tensor,
                       T: int, num_samples: int):
    """(dx (T,S,n), du (T,S,m)) from ``generator``, on its device."""
    dev = sx.device
    dx = torch.randn((T, num_samples, sx.shape[0]), generator=generator,
                     device=dev) * sx
    du = torch.randn((T, num_samples, su.shape[0]), generator=generator,
                     device=dev) * su
    return dx, du


def _draws(system, x_trj, generator, it, cfg, perturbations):
    if perturbations is not None:
        return perturbations
    sx, su = cfg.stds(it, system.dim_x, system.dim_u, x_trj.device)
    return draw_perturbations(generator, sx, su, x_trj.shape[0] - 1,
                              cfg.num_samples)


def _estimate_flat(system: System, mode: str, x_trj, u_trj, generator, it,
                   cfg: SmoothingConfig, perturbations, need_A: bool):
    """Estimation sweep over all knots as one flat batch.  Returns
    (AB (T,n,n+m), f_nom (T,n)); with ``need_A=False`` the A block of
    zero_order_B is zero (the caller overwrites it)."""
    x_nom = x_trj[:-1]
    f_nom = system.step_batch(x_nom, u_trj)

    if mode == "exact":
        return system.jacobian_xu_batch(x_nom, u_trj), f_nom

    dx, du = _draws(system, x_trj, generator, it, cfg, perturbations)
    # Projection applies only where the reference estimators use it
    # (first_order and the generic zero_order).
    if system.projection is not None and mode in ("first_order",
                                                  "zero_order"):
        xp, up = system.projection(x_nom, dx, u_trj, du)
    else:
        xp, up = x_nom[:, None] + dx, u_trj[:, None] + du

    if mode == "first_order":
        AB = _flat(system.jacobian_xu_batch, xp, up).mean(dim=1)
    elif mode == "zero_order":
        if system.projection is not None:
            dx, du = xp - x_nom[:, None], up - u_trj[:, None]
        fd = _flat(system.step_batch, xp, up)
        AB = _fit_lstsq(torch.cat([dx, du], dim=2), fd - f_nom[:, None])
    elif mode == "zero_order_B":
        # Samples share the nominal state (input-only sampling).
        xb = x_nom[:, None].expand(dx.shape)
        ub = u_trj[:, None] + du
        fd = _flat(system.step_batch, xb, ub)
        B_hat = _fit_lstsq(du, fd - f_nom[:, None])
        AB = torch.cat([_A_hat(system, cfg, x_nom, u_trj, du, need_A),
                        B_hat], dim=2)
    else:                                             # zero_order_AB
        fd = _flat(system.step_batch, xp, up)
        AB = _fit_lstsq(torch.cat([dx, du], dim=2), fd - f_nom[:, None],
                        damp=cfg.damp)
    return AB, f_nom


def _A_hat(system, cfg, x_nom, u_nom, du, need_A):
    """The A block of zero_order_B: the exact Jacobian at the nominal, or
    the mean Jacobian over the input samples; zeros without ``need_A``."""
    T, n = x_nom.shape
    if not need_A:
        return x_nom.new_zeros((T, n, n))
    if cfg.zero_order_B_A_source == "first_order":
        xb = x_nom[:, None].expand(du.shape[:2] + (n,))
        ub = u_nom[:, None] + du
        return _flat(system.jacobian_xu_batch, xb, ub).mean(dim=1)[:, :, :n]
    return system.jacobian_xu_batch(x_nom, u_nom)[:, :, :n]


def _fused_tv(system: System, mode: str, cfg: SmoothingConfig, x_nom,
              u_nom, du, dx=None, A=None):
    """The zero-order estimation through the system's fused sweep hook,
    after the draws: one ``est_sweep_fn`` call gives the nominal steps at
    full solver accuracy and every sample step; the per-knot fits run on
    the deltas.  ``dx`` is given where the mode samples the state;
    zero_order_B's A block is ``A`` (made by ``_A_hat``), zeros without
    it.  Returns (AB (T,n,n+m), c (T,n), f_nom (T,n))."""
    f_nom, fd = system.est_sweep_fn(x_nom, u_nom, dx, du)
    D = fd - f_nom[:, None, :]
    if mode == "zero_order":
        AB = _fit_lstsq(torch.cat([dx, du], dim=2), D)
    elif mode == "zero_order_AB":
        AB = _fit_lstsq(torch.cat([dx, du], dim=2), D, damp=cfg.damp)
    else:                                             # zero_order_B
        if A is None:
            A = _A_hat(system, cfg, x_nom, u_nom, du, need_A=False)
        AB = torch.cat([A, _fit_lstsq(du, D)], dim=2)
    n = system.dim_x
    return AB, _affine_c(AB[:, :, :n], AB[:, :, n:], f_nom, x_nom,
                         u_nom), f_nom


# The fused sweeps captured as CUDA graphs (``SweepGraph``): for each sweep
# function, a dict of its graphs by (mode, T, S, n, m, need_A, damp, dtype,
# device).  Weakly keyed by the sweep function itself: solvers that share
# an estimation surrogate share its graphs, and a graph's private pool is
# freed with the surrogate that made it.
SWEEP_GRAPHS = weakref.WeakKeyDictionary()


class SweepGraph:
    """``fn(**inputs)`` captured as one CUDA graph, replayed on new inputs.

    Built on the first call of its key: the inputs are copied into static
    buffers, ``fn`` runs once on a side stream (so that the device
    constants the sweep caches on first use, and cuBLAS's state, are made
    outside the capture), then is captured into a private memory pool.  A
    call copies its inputs into the static buffers, replays the graph and
    returns clones of the static outputs: a later replay overwrites the
    buffers, never what a caller holds.  The kernels' launch counters
    count the warm-up's launches and not the captured ones; a replay's
    are on the device trace, under its ``cudaGraphLaunch``."""

    def __init__(self, fn, inputs: dict):
        self.inputs = {k: t.clone() for k, t in inputs.items()}
        side = torch.cuda.Stream(self.inputs["du"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(**self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(**self.inputs)

    def __call__(self, **inputs):
        for k, t in inputs.items():
            self.inputs[k].copy_(t)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


def _estimate_fused(system: System, mode: str, x_trj, u_trj, generator, it,
                    cfg: SmoothingConfig, perturbations, need_A: bool):
    """Zero-order estimation through the fused sweep: the draws of the
    flat path (dx, then du) and zero_order_B's A where needed, eagerly;
    then ``_fused_tv``, replayed from its graph where every input is a
    float32 CUDA tensor and eagerly elsewhere.  Returns (AB, c, f_nom).
    The estimation span counts ``est_graph`` for each replay and
    ``est_capture`` for each capture."""
    dx, du = _draws(system, x_trj, generator, it, cfg, perturbations)
    inputs = dict(x_nom=x_trj[:-1], u_nom=u_trj, du=du)
    if mode != "zero_order_B":
        inputs["dx"] = dx
    elif need_A:
        inputs["A"] = _A_hat(system, cfg, x_trj[:-1], u_trj, du, need_A)
    fn = functools.partial(_fused_tv, system, mode, cfg)
    if not all(_nvcc.on_card(t) and t.dtype == torch.float32
               for t in inputs.values()):
        return fn(**inputs)
    T, S, m = du.shape
    graphs = SWEEP_GRAPHS.setdefault(system.est_sweep_fn, {})
    key = (mode, T, S, system.dim_x, m, need_A, cfg.damp, du.dtype,
           du.device)
    graph = graphs.get(key)
    if graph is None:
        graph = graphs[key] = SweepGraph(fn, inputs)
        timing.count("est_capture")
    timing.count("est_graph")
    return graph(**inputs)


def _affine_c(A, B, f_nom, x_nom, u_nom):
    return f_nom - torch.einsum("tij,tj->ti", A, x_nom) \
        - torch.einsum("tij,tj->ti", B, u_nom)


def estimate_tv_matrices_fnom(
        system: System, mode: str, x_trj: Tensor, u_trj: Tensor,
        generator: Optional[torch.Generator], it, cfg: SmoothingConfig,
        perturbations: Optional[tuple[Tensor, Tensor]] = None,
        need_A: bool = True):
    """Estimate (A_t, B_t, c_t); returns ``(tv, f_nom)`` with f_nom (T,n)
    the nominal steps, reusable by ``decouple_AB``.

    ``it`` is the 1-based iteration count that drives the variance decay.
    ``perturbations=(dx (T,S,n), du (T,S,m))`` supplies the scaled sample
    perturbations instead of drawing them from ``generator``.  A system
    with an ``est_sweep_fn`` and no projection takes the fused sweep in
    the zero-order modes, on float32 CUDA tensors as a graph replay
    (``SweepGraph``).  ``need_A=False`` skips zero_order_B's A (the
    caller is about to overwrite it, as ``decouple_AB`` does)."""
    if mode not in GRADIENT_MODES:
        raise ValueError(
            f"gradient mode {mode!r} not in {list(GRADIENT_MODES)}")
    n = system.dim_x
    fused = (system.est_sweep_fn is not None and system.projection is None
             and mode in ("zero_order", "zero_order_B", "zero_order_AB"))
    if fused:
        AB, c, f_nom = _estimate_fused(system, mode, x_trj, u_trj, generator,
                                       it, cfg, perturbations, need_A)
        return TvLinearization(A=AB[:, :, :n], B=AB[:, :, n:], c=c), f_nom
    AB, f_nom = _estimate_flat(system, mode, x_trj, u_trj, generator, it,
                               cfg, perturbations, need_A)
    A, B = AB[:, :, :n], AB[:, :, n:]
    return TvLinearization(A=A, B=B, c=_affine_c(A, B, f_nom, x_trj[:-1],
                                                 u_trj)), f_nom


def estimate_tv_matrices(system: System, mode: str, x_trj: Tensor,
                         u_trj: Tensor, generator, it, cfg: SmoothingConfig,
                         perturbations=None) -> TvLinearization:
    """Estimate (A_t, B_t, c_t) for every knot in one sweep."""
    tv, _ = estimate_tv_matrices_fnom(system, mode, x_trj, u_trj, generator,
                                      it, cfg, perturbations)
    return tv


def decouple_AB(tv: TvLinearization, indices_u_into_x, x_trj: Tensor,
                u_trj: Tensor, system: System,
                f_nom: Optional[Tensor] = None) -> TvLinearization:
    """Overwrite A_t with I minus the actuated columns and pin the actuated
    rows of B_t to the identity; c is re-derived for consistency.
    ``f_nom`` optionally supplies the nominal steps."""
    T, n, m = tv.B.shape
    eye_n = torch.eye(n, dtype=tv.A.dtype, device=tv.A.device)
    A = eye_n.expand(T, n, n).clone()
    with timing.span("sync"):       # the value 0 is copied from the host
        A[:, :, indices_u_into_x] = 0.0
    B = tv.B.clone()
    B[:, indices_u_into_x, :] = torch.eye(m, dtype=tv.B.dtype,
                                          device=tv.B.device)
    if f_nom is None:
        f_nom = system.step_batch(x_trj[:-1], u_trj)
    return TvLinearization(A=A, B=B,
                           c=_affine_c(A, B, f_nom, x_trj[:-1], u_trj))
