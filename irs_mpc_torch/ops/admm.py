"""Constrained TV-LQR: the boxed trajectory QP by ADMM with Riccati solves.

The counterpart of the JAX package's ``ops/admm.py``.  All four bound
kinds of the reference QP (absolute and relative, on states and inputs)
are boxes on stage-affine functions of the trajectory on the dynamics
manifold:

    s_x  = x_t,                 s_u  = u_t,
    s_dx = x_{t+1} - x_t = (A_t - I) x_t + B_t u_t + c_t,
    s_du = u_t - w_t            (w = the prev-input block of a Δu-augmented
                                 state, see lqr.build_delta_u_problem).

Each sweep is (1) the trajectory update, a Riccati solve of the stage cost
plus rho-penalties pulling each s toward (z - y); (2) z = clip(s_hat + y,
lb, ub) with the over-relaxed s_hat = a s + (1 - a) z; (3) y += s_hat - z.
Every quadratic penalty is rho S'S for a constant selector S, so the
Riccati factorisation is computed once and each sweep re-solves only the
affine recursion.

Device rule: CUDA tensors run the whole sweep loop as one launch of kernel
K3 (``cuda_admm``), after the unconstrained initial solve (K1); CPU tensors
run the factored plain loop below, which is K3's plain version.  Under
``parallel=True`` every sweep is a full associative-scan solve of the
penalised problem on either device (the JAX package's generic path for
its assoc backend), and no kernel is launched.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import timing
from . import _nvcc
from . import lqr as lqr_ops

Tensor = torch.Tensor

KINDS = ("x", "u", "dx", "du")


class BoxBounds(NamedTuple):
    """Per-stage box bounds; any member may be None (disabled).

    Shapes: x (2, T+1, n_phys) lb/ub on states incl. the final one;
            u (2, T, m); dx (2, T, n_phys); du (2, T, m)."""
    x: Optional[Tensor] = None
    u: Optional[Tensor] = None
    dx: Optional[Tensor] = None
    du: Optional[Tensor] = None


class AdmmSolution(NamedTuple):
    x_trj: Tensor          # (T+1, n), the augmented state in Δu mode
    u_trj: Tensor          # (T, m)
    # Gains of the final sweep.  Only K and k are guaranteed: the CUDA
    # kernel keeps the value function on chip, so P and p are None there.
    gains: lqr_ops.LqrGains
    r_primal: Tensor       # final primal residual (inf-norm)
    r_dual: Tensor         # final dual residual (inf-norm)


class _SVals(NamedTuple):
    """Stage values (or consensus / dual variables) per bound kind; None
    where a kind is not needed."""
    x: Optional[Tensor] = None
    u: Optional[Tensor] = None
    dx: Optional[Tensor] = None
    du: Optional[Tensor] = None


def _w_selector(idx_w, n, m, like):
    """W (m, n) with w = W x (the prev-input block)."""
    W = like.new_zeros((m, n))
    with timing.span("sync"):       # the value 1 is copied from the host
        W[torch.arange(m, device=like.device), idx_w] = 1.0
    return W


def _penalized_problem(prob: lqr_ops.LqrProblem, bounds: BoxBounds,
                       z: _SVals, y: _SVals, rho: float, n_phys: int,
                       idx_w: Optional[Tensor]):
    """The problem with the ADMM penalties added to its stage cost.
    Penalties on x and dx act on the first ``n_phys`` components of a
    possibly augmented state; ``idx_w`` gives the prev-input block for the
    du penalty."""
    T, n, m = prob.B.shape
    Q, R, N, Qf = _penalized_quadratics(prob, bounds, rho, n_phys, idx_w)
    q, r, qf = _penalized_linear_terms(prob, bounds, z, y, rho, n_phys,
                                       idx_w)
    return prob._replace(Q=Q.expand(T, n, n), R=R.expand(T, m, m),
                         N=N.expand(T, n, m), q=q, r=r, Qf=Qf, qf=qf)


def _penalized_quadratics(prob: lqr_ops.LqrProblem, bounds: BoxBounds,
                          rho: float, n_phys: int, idx_w: Optional[Tensor]):
    """(Q, R, N, Qf) of ``_penalized_problem``: the sweep-invariant part,
    which z and y do not enter."""
    T, n, m = prob.B.shape
    Q, R, N, Qf = prob.Q, prob.R, prob.N, prob.Qf
    eye_n = torch.eye(n, dtype=prob.A.dtype, device=prob.A.device)
    eye_m = torch.eye(m, dtype=prob.A.dtype, device=prob.A.device)

    if bounds.x is not None:
        sel = eye_n[:n_phys]
        Q = Q + rho * (sel.T @ sel)
        Qf = Qf + rho * (sel.T @ sel)
    if bounds.u is not None:
        R = R + rho * eye_m
    if bounds.dx is not None:
        D = prob.A[:, :n_phys, :] - eye_n[None, :n_phys, :]
        Bp = prob.B[:, :n_phys, :]
        Q = Q + rho * D.transpose(1, 2) @ D
        R = R + rho * Bp.transpose(1, 2) @ Bp
        N = N + rho * D.transpose(1, 2) @ Bp
    if bounds.du is not None:
        # rho || u - W x - v ||^2
        W = _w_selector(idx_w, n, m, prob.A)
        Q = Q + rho * (W.T @ W)
        R = R + rho * eye_m
        N = N - rho * W.T
    return Q, R, N, Qf


def _penalized_linear_terms(prob: lqr_ops.LqrProblem, bounds: BoxBounds,
                            z: _SVals, y: _SVals, rho: float, n_phys: int,
                            idx_w: Optional[Tensor]):
    """The (q, r, qf) of ``_penalized_problem`` alone: the only terms the
    consensus variables z and y enter."""
    T, n, m = prob.B.shape
    q, r, qf = prob.q, prob.r, prob.qf
    pad = n - n_phys

    def head(v):
        """(..., n_phys) -> (..., n), zeros in the tail block."""
        return torch.nn.functional.pad(v, (0, pad)) if pad else v

    if bounds.x is not None:
        vx = z.x - y.x
        q = q - rho * head(vx[:-1])
        qf = qf - rho * head(vx[-1])
    if bounds.u is not None:
        r = r - rho * (z.u - y.u)
    if bounds.dx is not None:
        eye_n = torch.eye(n, dtype=prob.A.dtype, device=prob.A.device)
        D = prob.A[:, :n_phys, :] - eye_n[None, :n_phys, :]
        Bp = prob.B[:, :n_phys, :]
        e = prob.c[:, :n_phys] - (z.dx - y.dx)
        q = q + rho * torch.einsum("tij,ti->tj", D, e)
        r = r + rho * torch.einsum("tij,ti->tj", Bp, e)
    if bounds.du is not None:
        vdu = z.du - y.du
        W = _w_selector(idx_w, n, m, prob.A)
        q = q + rho * vdu @ W
        r = r - rho * vdu
    return q, r, qf


def _stage_values(prob, x_trj, u_trj, n_phys, idx_w) -> _SVals:
    xs = x_trj[:, :n_phys]
    du = (u_trj - x_trj[:-1][:, idx_w] if idx_w is not None
          else torch.zeros_like(u_trj))
    return _SVals(x=xs, u=u_trj, dx=xs[1:] - xs[:-1], du=du)


def _residuals(s: _SVals, z: _SVals, z_prev: _SVals, bounds: BoxBounds,
               rho: float):
    """Primal and dual residuals over the ENABLED bound kinds only."""
    enabled = [k for k in KINDS if getattr(bounds, k) is not None]
    r_primal = torch.stack([(getattr(s, k) - getattr(z, k)).abs().max()
                            for k in enabled]).max()
    r_dual = rho * torch.stack([
        (getattr(z, k) - getattr(z_prev, k)).abs().max()
        for k in enabled]).max()
    return r_primal, r_dual


def solve_boxed_tvlqr(prob: lqr_ops.LqrProblem, bounds: BoxBounds,
                      n_phys: int, idx_w: Optional[Tensor] = None,
                      rho: float = 1.0, iters: int = 60,
                      over_relax: float = 1.0,
                      parallel: bool = False) -> AdmmSolution:
    """Solve the boxed TV-LQR QP by ``iters`` ADMM sweeps.  ``prob`` may be
    Δu-augmented (then ``idx_w`` points at the prev-input block and
    ``n_phys`` < n).  ``over_relax`` in [1, 2) is the ADMM relaxation a
    (1.0 is plain ADMM).  All-None bounds give the unconstrained solve.

    ``parallel`` runs the initial solve and every sweep as a full
    associative-scan solve of the penalised problem (``lqr_solve(...,
    parallel=True)``), as plain tensor ops on either device: neither K1
    nor K3 is launched."""
    if all(b is None for b in bounds):
        x_trj, u_trj, gains = lqr_ops.lqr_solve(prob, parallel=parallel)
        zero = prob.A.new_zeros(())
        return AdmmSolution(x_trj=x_trj, u_trj=u_trj, gains=gains,
                            r_primal=zero, r_dual=zero)

    # z starts at the unconstrained solution projected onto the boxes.
    x0_trj, u0_trj, gains0 = lqr_ops.lqr_solve(prob, parallel=parallel)
    s0 = _stage_values(prob, x0_trj, u0_trj, n_phys, idx_w)
    z0 = _SVals(**{k: _clip(getattr(s0, k), getattr(bounds, k))
                   for k in KINDS if getattr(bounds, k) is not None})
    y0 = _SVals(**{k: torch.zeros_like(getattr(z0, k))
                   for k in KINDS if getattr(bounds, k) is not None})

    device = prob.A.device
    if iters < 1:
        # No sweep: the unconstrained solution, with z = z_prev = z0.
        r_primal, r_dual = _residuals(s0, z0, z0, bounds, rho)
        return AdmmSolution(x_trj=x0_trj, u_trj=u0_trj, gains=gains0,
                            r_primal=r_primal, r_dual=r_dual)
    if parallel:
        x_trj, u_trj, gains, z, z_prev = _admm_assoc(
            prob, bounds, z0, y0, n_phys, idx_w, rho, iters, over_relax)
    elif _nvcc.on_card(prob.A):
        from .cuda_admm import solve_boxed_tvlqr_cuda
        x_trj, u_trj, K, k, z, z_prev = solve_boxed_tvlqr_cuda(
            prob, bounds, z0, y0, n_phys=n_phys, idx_w=idx_w, rho=rho,
            iters=iters, over_relax=over_relax)
        gains = lqr_ops.LqrGains(K=K, k=k, P=None, p=None)
    elif device.type == "cpu":
        x_trj, u_trj, gains, z, z_prev = _admm_plain(
            prob, bounds, z0, y0, n_phys, idx_w, rho, iters, over_relax)
    else:
        raise ValueError(f"no boxed ADMM for device {device}")
    s = _stage_values(prob, x_trj, u_trj, n_phys, idx_w)
    r_primal, r_dual = _residuals(s, z, z_prev, bounds, rho)
    return AdmmSolution(x_trj=x_trj, u_trj=u_trj, gains=gains,
                        r_primal=r_primal, r_dual=r_dual)


def _clip(v, b):
    return torch.minimum(torch.maximum(v, b[0]), b[1])


def _consensus(s: _SVals, z: _SVals, y: _SVals, bounds: BoxBounds, a):
    """The over-relaxed z and y updates of one sweep from its stage values
    ``s``, over the enabled bound kinds."""
    z_new, y_new = {}, {}
    for k in KINDS:
        if getattr(bounds, k) is None:
            continue
        sh = a * getattr(s, k) + (1.0 - a) * getattr(z, k)
        z_new[k] = _clip(sh + getattr(y, k), getattr(bounds, k))
        y_new[k] = getattr(y, k) + sh - z_new[k]
    return _SVals(**z_new), _SVals(**y_new)


def _admm_plain(prob, bounds, z, y, n_phys, idx_w, rho, iters, a):
    """The factored sweep loop, K3's plain version.  Returns (x, u, gains,
    z, z_prev) of the last sweep."""
    pen0 = _penalized_problem(prob, bounds, z, y, rho, n_phys, idx_w)
    fac = lqr_ops.riccati_factorize(pen0)
    z_prev = z
    for _ in range(int(iters)):
        q, r, qf = _penalized_linear_terms(prob, bounds, z, y, rho, n_phys,
                                           idx_w)
        pen = pen0._replace(q=q, r=r, qf=qf)
        gains = lqr_ops.riccati_linear(pen, fac)
        x_trj, u_trj = lqr_ops.lqr_rollout_linear(pen, gains)
        s = _stage_values(prob, x_trj, u_trj, n_phys, idx_w)
        z_prev, (z, y) = z, _consensus(s, z, y, bounds, a)
    return x_trj, u_trj, gains, z, z_prev


def _admm_assoc(prob, bounds, z, y, n_phys, idx_w, rho, iters, a):
    """The unfactored sweep loop of the associative-scan route: every sweep
    solves the whole penalised problem by ``riccati_backward_assoc`` and
    the linear plan.  Returns (x, u, gains, z, z_prev) of the last
    sweep."""
    z_prev = z
    for _ in range(int(iters)):
        pen = _penalized_problem(prob, bounds, z, y, rho, n_phys, idx_w)
        x_trj, u_trj, gains = lqr_ops.lqr_solve(pen, parallel=True)
        s = _stage_values(prob, x_trj, u_trj, n_phys, idx_w)
        z_prev, (z, y) = z, _consensus(s, z, y, bounds, a)
    return x_trj, u_trj, gains, z, z_prev
