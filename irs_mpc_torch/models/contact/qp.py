"""Differentiable dense convex QP layer, batched over leading dims.

The counterpart of the JAX package's ``models/contact/qp.py``: the contact
step is one small convex QP per step,

    min_x  1/2 x'Px + q'x   s.t.  C x <= d,

solved by a primal-dual interior point method with a FIXED iteration count
(``_pdip_solve``), with the implicit-function JVP of the KKT system as its
forward-mode derivative (``solve_qp``).  ``_pdip_solve`` over a leading
batch is the plain version of kernel K2 (``cuda_qp``).
"""
from __future__ import annotations

import torch

from ...ops.linalg import solve_spd

Tensor = torch.Tensor

# Shared active-set scaling cap: the forward PDIP solve and the implicit JVP
# must agree on how stiff an "active" constraint can get.
W_CAP = 1e10
MU_FLOOR = 3e-7


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product (..., a, b) x (..., b) -> (..., a)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _max_step(v: Tensor, dv: Tensor) -> Tensor:
    """Fraction-to-boundary step over the last dim, as (..., 1)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(0.995 * ratio.amin(-1, keepdim=True), max=1.0)


def _pdip_solve(P, q, C, d, iters: int, sigma: float = 0.25, init=None):
    """Primal-dual interior point with a fixed iteration count, over any
    leading batch dims: P (..., n, n), q (..., n), C (..., m, n), d (..., m).
    Returns (x, s, lam).

    ``init=(x_prev, lam_prev)`` warm-starts from a previous solution: the
    primal starts at x_prev (zeros if it is not finite), the slacks are
    shifted uniformly by ``delta = 1e-2`` past the most violated row, and
    the duals keep the previous active-set memory, floored and capped.
    The cold start solves the ridge-regularised unconstrained minimum and
    shifts the slacks by 1.  The iterate runs unguarded; the last finite
    primal iterate is returned, and non-finite duals are sanitised."""
    n = q.shape[-1]
    m = d.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    Ct = C.transpose(-1, -2)

    if init is None:
        x0 = solve_spd(P + 1e-8 * eye, -q)
        slack0 = d - _mv(C, x0)
        shift = torch.clamp(-slack0.amin(-1, keepdim=True), min=0.0) + 1.0
        s0 = slack0 + shift
        lam0 = torch.ones_like(s0)
    else:
        x_prev, lam_prev = init
        delta = 1e-2
        ok = torch.isfinite(x_prev).all(-1, keepdim=True)
        x0 = torch.where(ok, x_prev, torch.zeros_like(x_prev))
        slack0 = d - _mv(C, x0)
        shift = torch.clamp(-slack0.amin(-1, keepdim=True), min=0.0) + delta
        s0 = slack0 + shift
        lam_prev = torch.where(torch.isfinite(lam_prev), lam_prev,
                               torch.ones_like(lam_prev))
        lam0 = torch.clamp(lam_prev, delta, 1e6).expand_as(s0)

    x, s, lam, x_keep = x0, s0, lam0, x0
    for _ in range(int(iters)):
        mu = torch.clamp((s * lam).sum(-1, keepdim=True) / m, min=MU_FLOOR)
        r_d = _mv(P, x) + q + _mv(Ct, lam)
        r_p = _mv(C, x) + s - d
        r_c = lam * s - sigma * mu

        s_safe = torch.clamp(s, min=1e-7)
        w = torch.clamp(lam / s_safe, max=W_CAP)
        H = P + (Ct * w.unsqueeze(-2)) @ C
        rhs = -(r_d + _mv(Ct, w * r_p - r_c / s_safe))
        dx = solve_spd(H + 1e-8 * eye, rhs)
        ds = -r_p - _mv(C, dx)
        dlam = (-r_c - lam * ds) / s_safe

        alpha = torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        x_new = x + alpha * dx
        ok = torch.isfinite(x_new).all(-1, keepdim=True)
        x_keep = torch.where(ok, x_new, x_keep)
        x, s, lam = x_new, s + alpha * ds, lam + alpha * dlam
    s = torch.where(torch.isfinite(s), s, torch.full_like(s, 1e-7))
    lam = torch.where(torch.isfinite(lam), lam, torch.zeros_like(lam))
    return x_keep, s, lam


def _zero_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


class _SolveQP(torch.autograd.Function):
    """Forward: ``_pdip_solve``; forward-mode derivative: implicit
    differentiation of the relaxed KKT system with the duals' sensitivity
    D = lam/s (capped at W_CAP), the soft active set, as in the JAX
    package's ``custom_jvp`` (whose float32 solve the port widens to
    float64, see ``jvp``).  ``jvp`` and ``generate_vmap_rule`` make
    ``torch.func.jacfwd`` and ``vmap`` use it; nothing differentiates
    through the unrolled iterations."""
    generate_vmap_rule = True

    @staticmethod
    def forward(P, q, C, d, iters):
        return _pdip_solve(P, q, C, d, iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        P, q, C, d, _ = inputs
        x, s, lam = output
        ctx.out_dtype = x.dtype
        ctx.save_for_forward(P, C, x, s, lam)
        ctx.mark_non_differentiable(s, lam)

    @staticmethod
    def jvp(ctx, dP, dq, dC, dd, _):
        """The KKT system is formed and solved in (at least) float64, and
        the tangent returned in the solution's dtype.  An active row
        carries D up to 1e9-1e10, so in float32 the digits of P are lost
        in P + C'DC: the derivative is then determined only to O(1) of its
        largest entry, and a few such samples poison an averaged
        first-order Jacobian (the second-order planar hand's zero_order_B
        stalled near 18.5 against the JAX package's 6.1 on the same
        configuration).  The forward solve stays in the input's dtype."""
        P, C, x, s, lam = ctx.saved_tensors
        wide = torch.promote_types(x.dtype, torch.float64)
        dP, dq = _zero_if_none(dP, P), _zero_if_none(dq, x)
        dC, dd = _zero_if_none(dC, C), _zero_if_none(dd, s)
        P, C, x, s, lam, dP, dq, dC, dd = (
            t.to(wide) for t in (P, C, x, s, lam, dP, dq, dC, dd))
        n = x.shape[-1]
        D = torch.clamp(lam / torch.clamp(s, min=1e-8), max=W_CAP)
        Ct = C.transpose(-1, -2)
        H = P + (Ct * D.unsqueeze(-2)) @ C \
            + 1e-10 * torch.eye(n, dtype=wide, device=P.device)
        rhs = -(_mv(dP, x) + dq + _mv(dC.transpose(-1, -2), lam)) \
            + _mv(Ct, D * (dd - _mv(dC, x)))
        return solve_spd(H, rhs).to(ctx.out_dtype), None, None

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "solve_qp has a forward-mode derivative only (jacfwd / jvp)")


def solve_qp(P: Tensor, q: Tensor, C: Tensor, d: Tensor,
             iters: int = 30) -> Tensor:
    """Differentiable (forward mode) argmin of the inequality-constrained
    QP, over any leading batch dims."""
    return _SolveQP.apply(P, q, C, d, int(iters))[0]


def solve_qp_with_duals(P, q, C, d, iters: int = 30):
    """Non-differentiable variant returning (x, s, lam) for diagnostics."""
    return _pdip_solve(P, q, C, d, iters)


def solve_qp_warm(P, q, C, d, ws, iters: int = 10):
    """Warm-started solve for serial rollout chains (non-differentiable).

    ``ws = (x_prev, lam_prev)`` from the previous knot's solve.  Returns
    ``(x, (x, lam))``: the solution and the carry for the next knot, with
    non-finite duals replaced so one rescued solve cannot poison the
    chain."""
    x, _, lam = _pdip_solve(P, q, C, d, iters, init=ws)
    lam = torch.where(torch.isfinite(lam), lam, torch.ones_like(lam))
    return x, (x, lam)
