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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..models.base import System
from ..utils import timing
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


def _estimate_fused(system: System, mode: str, x_trj, u_trj, generator, it,
                    cfg: SmoothingConfig, perturbations, need_A: bool):
    """Zero-order estimation through the system's fused sweep hook: one
    ``est_sweep_fn`` call gives the nominal steps at full solver accuracy
    and every sample step; the per-knot fits run on the deltas.  Returns
    (AB (T,n,n+m), f_nom (T,n)).  The draws are those of the flat path
    (dx, then du)."""
    dx, du = _draws(system, x_trj, generator, it, cfg, perturbations)
    f_nom, fd = system.est_sweep_fn(
        x_trj[:-1], u_trj, None if mode == "zero_order_B" else dx, du)
    D = fd - f_nom[:, None, :]
    if mode == "zero_order":
        AB = _fit_lstsq(torch.cat([dx, du], dim=2), D)
    elif mode == "zero_order_AB":
        AB = _fit_lstsq(torch.cat([dx, du], dim=2), D, damp=cfg.damp)
    else:                                             # zero_order_B
        AB = torch.cat([_A_hat(system, cfg, x_trj[:-1], u_trj, du, need_A),
                        _fit_lstsq(du, D)], dim=2)
    return AB, f_nom


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
    the zero-order modes.  ``need_A=False`` skips zero_order_B's A (the
    caller is about to overwrite it, as ``decouple_AB`` does)."""
    if mode not in GRADIENT_MODES:
        raise ValueError(
            f"gradient mode {mode!r} not in {list(GRADIENT_MODES)}")
    n = system.dim_x
    fused = (system.est_sweep_fn is not None and system.projection is None
             and mode in ("zero_order", "zero_order_B", "zero_order_AB"))
    estimate = _estimate_fused if fused else _estimate_flat
    AB, f_nom = estimate(system, mode, x_trj, u_trj, generator, it, cfg,
                         perturbations, need_A)
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
