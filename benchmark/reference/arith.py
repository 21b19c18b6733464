"""The reference's arithmetic and its small solvers: one object says in
which dtype the reference computes and whether its matrix products round
their operands to TF32, the precision a GPU's tensor cores multiply
float32 in when TF32 is allowed (10 mantissa bits, rounded to nearest,
ties away from zero; sums in float32).  The sound reference is float64
with exact products; the control, the precision below the configuration's
float32-without-TF32, is float32 with TF32 products."""
from __future__ import annotations

import torch

# Active-set scaling cap and complementarity floor of the contact QP (the
# upstream solver's constants).
W_CAP = 1e10
MU_FLOOR = 3e-7


def round_tf32(a):
    """``a`` (float32) with each element rounded to TF32's 10 mantissa
    bits; non-finite elements unchanged."""
    bits = a.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(a), rounded, a)


class Arith:
    """``dtype`` of every tensor the reference makes, on ``device``; with
    ``tf32`` (float32 only) every matrix product rounds its operands to
    TF32 first."""

    def __init__(self, dtype=torch.float64, tf32=False, device="cpu"):
        if tf32 and dtype is not torch.float32:
            raise ValueError("TF32 products take float32 operands")
        self.dtype, self.tf32, self.device = dtype, tf32, torch.device(device)

    def __call__(self, a):
        """``a`` (an array, a number or a tensor) in the reference's dtype
        on its device."""
        return torch.as_tensor(a).to(self.device, self.dtype)

    def _r(self, a):
        return round_tf32(a) if self.tf32 else a

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def mv(self, M, v):
        """(..., a, b) x (..., b) -> (..., a)."""
        return self.mm(M, v.unsqueeze(-1)).squeeze(-1)

    def ein(self, eq, *ops):
        return torch.einsum(eq, *(self._r(o) for o in ops))

    def eye(self, n):
        return torch.eye(n, dtype=self.dtype, device=self.device)


def solve_spd(A, b):
    """``A x = b`` for small SPD or diagonally dominant A by Gauss-Jordan
    elimination without pivoting, batched; b (..., n) or (..., n, k)."""
    n = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    if vec:
        b = b.unsqueeze(-1)
    M = torch.cat([A, b], dim=-1)
    for k in range(n):
        row = M[..., k:k + 1, :] / M[..., k:k + 1, k:k + 1]
        M = M - M[..., :, k:k + 1] * row
        M = torch.cat([M[..., :k, :], row, M[..., k + 1:, :]], dim=-2)
    x = M[..., n:]
    return x[..., 0] if vec else x


def _max_step(v, dv):
    """Fraction-to-boundary step over the last dim, as (..., 1)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(0.995 * ratio.amin(-1, keepdim=True), max=1.0)


def pdip(ar, P, q, C, d, iters, sigma=0.25, init=None):
    """min 1/2 x'Px + q'x s.t. Cx <= d by a primal-dual interior point
    method with a fixed iteration count, batched over leading dims.
    Returns (x, s, lam).  Cold: the ridge-regularised unconstrained
    minimum, slacks shifted by 1 past the most violated row, duals 1.
    Warm (``init=(x, lam)`` of a previous solve): that primal (zeros where
    not finite), slacks shifted by 1e-2, the duals floored at 1e-2 and
    capped at 1e6.  The last finite primal iterate is returned; non-finite
    slacks and duals are sanitised."""
    n, m = q.shape[-1], d.shape[-1]
    eye = ar.eye(n)
    Ct = C.transpose(-1, -2)
    if init is None:
        x0 = solve_spd(P + 1e-8 * eye, -q)
        slack0 = d - ar.mv(C, x0)
        s0 = slack0 + torch.clamp(-slack0.amin(-1, keepdim=True),
                                  min=0.0) + 1.0
        lam0 = torch.ones_like(s0)
    else:
        x_prev, lam_prev = init
        ok = torch.isfinite(x_prev).all(-1, keepdim=True)
        x0 = torch.where(ok, x_prev, torch.zeros_like(x_prev))
        slack0 = d - ar.mv(C, x0)
        s0 = slack0 + torch.clamp(-slack0.amin(-1, keepdim=True),
                                  min=0.0) + 1e-2
        lam_prev = torch.where(torch.isfinite(lam_prev), lam_prev,
                               torch.ones_like(lam_prev))
        lam0 = torch.clamp(lam_prev, 1e-2, 1e6).expand_as(s0)
    x, s, lam, keep = x0, s0, lam0, x0
    for _ in range(int(iters)):
        mu = torch.clamp((s * lam).sum(-1, keepdim=True) / m, min=MU_FLOOR)
        r_d = ar.mv(P, x) + q + ar.mv(Ct, lam)
        r_p = ar.mv(C, x) + s - d
        r_c = lam * s - sigma * mu
        s_safe = torch.clamp(s, min=1e-7)
        w = torch.clamp(lam / s_safe, max=W_CAP)
        H = P + ar.mm(Ct * w.unsqueeze(-2), C)
        rhs = -(r_d + ar.mv(Ct, w * r_p - r_c / s_safe))
        dx = solve_spd(H + 1e-8 * eye, rhs)
        ds = -r_p - ar.mv(C, dx)
        dlam = (-r_c - lam * ds) / s_safe
        alpha = torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        x_new = x + alpha * dx
        keep = torch.where(torch.isfinite(x_new).all(-1, keepdim=True),
                           x_new, keep)
        x, s, lam = x_new, s + alpha * ds, lam + alpha * dlam
    s = torch.where(torch.isfinite(s), s, torch.full_like(s, 1e-7))
    lam = torch.where(torch.isfinite(lam), lam, torch.zeros_like(lam))
    return keep, s, lam
