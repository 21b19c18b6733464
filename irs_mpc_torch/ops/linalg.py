"""Small-matrix linear algebra: unrolled Gauss-Jordan, batched.

Every linear solve of the solver is small (Riccati ``H``, least-squares Gram
matrices) and symmetric positive definite or ridge-regularised, so the
elimination runs without pivoting, exactly as the JAX package's
``ops/linalg.py`` does.  Keeping the same arithmetic (and not
``torch.linalg.solve``, which pivots) keeps the port's answers on the same
ill-conditioned Gram matrices close to the reference's.  (The reference
hands systems above n = 64 to a library solver; no caller of the port has
one, so the elimination runs at every size.)
"""
from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for SPD or diagonally dominant ``A``, batched over
    any leading dims.  A: (..., n, n); b: (..., n) or (..., n, k)."""
    n = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    if vec:
        b = b.unsqueeze(-1)

    M = torch.cat([A, b], dim=-1)                 # (..., n, n+k)
    for k in range(n):
        piv = M[..., k:k + 1, k:k + 1]
        row_k = M[..., k:k + 1, :] / piv
        factors = M[..., :, k:k + 1]
        M = M - factors * row_k
        M = torch.cat([M[..., :k, :], row_k, M[..., k + 1:, :]], dim=-2)
    x = M[..., n:]
    return x[..., 0] if vec else x


def inv_spd(A: torch.Tensor) -> torch.Tensor:
    """Inverse of small SPD or diagonally dominant matrices (batched)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return solve_spd(A, eye)
