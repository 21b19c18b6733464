"""Time-varying LQR backward and forward passes.

The problem is the canonical stage form of the JAX package's ``ops/lqr.py``:

    min  sum_t [ x'Q_t x + u'R_t u + 2 x'N_t u + 2 q_t'x + 2 r_t'u ]
         + x_T'Q_T x_T + 2 q_T'x_T
    s.t. x_{t+1} = A_t x_t + B_t u_t + c_t,  x_0 given

(no 1/2 factors).  ``riccati_backward`` and ``lqr_solve`` follow the
tensors' device: CUDA tensors go through the hand-written kernel
(``cuda_riccati``; ``lqr_solve`` rolls the linear plan out in the same
launch), CPU tensors through the plain loop ``riccati_backward_plain`` (and
``lqr_rollout_linear`` after it).  Backend ``"assoc"`` (or
``lqr_solve(..., parallel=True)``) takes the associative-scan pass
``riccati_backward_assoc`` instead, as plain tensor ops on either device:
its counterpart in the JAX package is ``lax.associative_scan``, not a
Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _nvcc, cuda_riccati
from .linalg import solve_spd

Tensor = torch.Tensor


class LqrProblem(NamedTuple):
    """Canonical affine-quadratic trajectory problem (see module docstring).

    Shapes: A (T,n,n), B (T,n,m), c (T,n), Q (T,n,n), R (T,m,m), N (T,n,m),
    q (T,n), r (T,m), Qf (n,n), qf (n,), x0 (n,).
    """
    A: Tensor
    B: Tensor
    c: Tensor
    Q: Tensor
    R: Tensor
    N: Tensor
    q: Tensor
    r: Tensor
    Qf: Tensor
    qf: Tensor
    x0: Tensor


BACKENDS = ("auto", "assoc")


class LqrGains(NamedTuple):
    """Affine feedback u_t = -(K_t x_t + k_t) and value function (P_t, p_t).

    The CUDA kernel keeps P and p on chip, so they are None on that path."""
    K: Tensor                  # (T, m, n)
    k: Tensor                  # (T, m)
    P: Optional[Tensor]        # (T+1, n, n)
    p: Optional[Tensor]        # (T+1, n)


def riccati_backward_plain(prob: LqrProblem) -> LqrGains:
    """Sequential Riccati recursion, one plain loop step per knot.

    With value function V_t(x) = x'P_t x + 2 p_t'x + const:
        H = R_t + B'P B            (m,m)
        G = N_t' + B'P A           (m,n)
        g = r_t + B'(P c + p)      (m,)
        K = H^{-1} G,  k = H^{-1} g
        P_t = Q_t + A'P A - G'K    (symmetrised)
        p_t = q_t + A'(P c + p) - G'k
    """
    T = prob.B.shape[0]
    P, p = prob.Qf, prob.qf
    Ks, ks, Ps, ps = [None] * T, [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        A, B, c = prob.A[t], prob.B[t], prob.c[t]
        Q, R, N, q, r = prob.Q[t], prob.R[t], prob.N[t], prob.q[t], prob.r[t]
        PB = P @ B
        H = R + B.T @ PB
        G = N.T + B.T @ (P @ A)
        Pc_p = P @ c + p
        g = r + B.T @ Pc_p
        # Solve H [K k] = [G g] in one elimination.
        Kk = solve_spd(H, torch.cat([G, g[:, None]], dim=1))
        K, k = Kk[:, :-1], Kk[:, -1]
        P_new = Q + A.T @ (P @ A) - G.T @ K
        P_new = 0.5 * (P_new + P_new.T)
        p_new = q + A.T @ Pc_p - G.T @ k
        Ks[t], ks[t], Ps[t], ps[t] = K, k, P, p
        P, p = P_new, p_new
    return LqrGains(K=torch.stack(Ks), k=torch.stack(ks),
                    P=torch.stack([P] + Ps), p=torch.stack([p] + ps))


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"riccati backend {backend!r} not in {BACKENDS}")


def riccati_backward(prob: LqrProblem, backend: str = "auto") -> LqrGains:
    """Riccati backward pass by the tensors' device, or by the associative
    scan under ``backend="assoc"``.

    "auto": CUDA tensors launch the hand-written kernel and raise if it
    cannot run; CPU tensors run ``riccati_backward_plain``."""
    _check_backend(backend)
    if backend == "assoc":
        return riccati_backward_assoc(prob)
    device = prob.A.device
    if _nvcc.on_card(prob.A):
        K, k = cuda_riccati.riccati_backward_cuda(
            LqrProblem(*(a.contiguous() for a in prob)))
        return LqrGains(K=K, k=k, P=None, p=None)
    if device.type == "cpu":
        return riccati_backward_plain(prob)
    raise ValueError(f"no Riccati backward pass for device {device}")


class _AssocElem(NamedTuple):
    """An element of the parallel-in-time LQR (Särkkä and García-Fernández,
    2021): the conditional value function between two times, V(x_i ->
    x_j), parameterised by (F, b, C, eta, J), batched over a leading
    dim."""
    F: Tensor
    b: Tensor
    C: Tensor
    eta: Tensor
    J: Tensor


def _assoc_combine(e1: _AssocElem, e2: _AssocElem) -> _AssocElem:
    """The associative combination of ``e1`` (earlier) with ``e2``
    (later), batched over leading dims; vectors are lifted to (..., n, 1)
    columns so that every product is a batched matmul."""
    n = e1.F.shape[-1]
    eye = torch.eye(n, dtype=e1.F.dtype, device=e1.F.device).expand(
        e1.F.shape)
    M = torch.linalg.solve(eye + e1.C @ e2.J, eye)      # (I + C1 J2)^-1
    Mt = torch.linalg.solve(eye + e2.J @ e1.C, eye)     # (I + J2 C1)^-1
    F2M = e2.F @ M
    F1t = e1.F.transpose(-1, -2)
    b1 = e1.b[..., None]
    eta2 = e2.eta[..., None]
    return _AssocElem(
        F=F2M @ e1.F,
        b=(F2M @ (b1 + e1.C @ eta2))[..., 0] + e2.b,
        C=F2M @ e1.C @ e2.F.transpose(-1, -2) + e2.C,
        eta=(F1t @ Mt @ (eta2 - e2.J @ b1))[..., 0] + e1.eta,
        J=F1t @ Mt @ e2.J @ e1.F + e1.J)


def _suffix_scan(elems: _AssocElem) -> _AssocElem:
    """Reversed inclusive scan over the leading dim of length L: element t
    of the result composes elements t..L-1.  Hillis-Steele, ceil(log2 L)
    levels; a level of stride d combines every element t < L - d with
    element t + d in one batched ``_assoc_combine``."""
    L = elems.F.shape[0]
    d = 1
    while d < L:
        head = _assoc_combine(_AssocElem(*(a[:L - d] for a in elems)),
                              _AssocElem(*(a[d:] for a in elems)))
        elems = _AssocElem(*(torch.cat([h, a[L - d:]])
                             for h, a in zip(head, elems)))
        d *= 2
    return elems


def riccati_backward_assoc(prob: LqrProblem) -> LqrGains:
    """Associative-scan Riccati backward pass, O(log T) deep in time.

    The cross term N and the linear input term r are eliminated by the
    substitution u = v - R^-1 (N'x + r), which leaves every stage in the
    tracking form of the parallel formulation; the per-stage elements and
    the terminal one go through a reversed scan, and the gains are
    recovered from the value function (P, p) at t+1 as in the sequential
    pass.  Returns P and p of length T+1."""
    T, n, m = prob.B.shape
    Rinv_N = torch.linalg.solve(prob.R, prob.N.transpose(1, 2))   # (T,m,n)
    Rinv_r = torch.linalg.solve(prob.R, prob.r[..., None])[..., 0]
    A_bar = prob.A - prob.B @ Rinv_N
    c_bar = prob.c - (prob.B @ Rinv_r[..., None])[..., 0]
    Q_bar = prob.Q - prob.N @ Rinv_N
    q_bar = prob.q - (prob.N @ Rinv_r[..., None])[..., 0]

    # Element t maps V_{t+1} to V_t for the stage cost x'Q̄x + 2q̄'x + v'Rv
    # and the dynamics x' = Āx + Bv + c̄; the last element is the terminal
    # cost.
    BRB = prob.B @ torch.linalg.solve(prob.R, prob.B.transpose(1, 2))
    zeros = prob.A.new_zeros((1, n, n))
    elems = _AssocElem(
        F=torch.cat([A_bar, zeros]),
        b=torch.cat([c_bar, prob.A.new_zeros((1, n))]),
        C=torch.cat([BRB, zeros]),
        eta=torch.cat([-q_bar, -prob.qf[None]]),
        J=torch.cat([Q_bar, prob.Qf[None]]))
    # Element t of the scan composes stages t..T: V_t(x) = x'Jx - 2 eta'x.
    combined = _suffix_scan(elems)
    P, p = combined.J, -combined.eta

    P1, p1 = P[1:], p[1:]
    Bt = prob.B.transpose(1, 2)
    H = prob.R + Bt @ (P1 @ prob.B)
    G = prob.N.transpose(1, 2) + Bt @ (P1 @ prob.A)
    Pc_p = (P1 @ prob.c[..., None])[..., 0] + p1
    g = prob.r + (Bt @ Pc_p[..., None])[..., 0]
    Kk = solve_spd(H, torch.cat([G, g[..., None]], dim=2))
    return LqrGains(K=Kk[..., :-1], k=Kk[..., -1], P=P, p=p)


class RiccatiFactorization(NamedTuple):
    """Sweep-invariant Riccati data (depends only on A, B, Q, R, N, Qf).

    ADMM box penalties change only the linear cost terms (q, r, qf) from
    one sweep to the next, so K, H, G and P are factored once and each
    sweep re-solves the affine recursion (``riccati_linear``)."""
    K: Tensor   # (T, m, n)
    H: Tensor   # (T, m, m)
    G: Tensor   # (T, m, n)
    P: Tensor   # (T+1, n, n)  (P[t] = value Hessian at time t)


def riccati_factorize(prob: LqrProblem) -> RiccatiFactorization:
    """Backward pass over the quadratic terms only (q/r/qf never read)."""
    T = prob.B.shape[0]
    P = prob.Qf
    Ks, Hs, Gs, Ps = [None] * T, [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        A, B = prob.A[t], prob.B[t]
        H = prob.R[t] + B.T @ (P @ B)
        G = prob.N[t].T + B.T @ (P @ A)
        K = solve_spd(H, G)
        P_new = prob.Q[t] + A.T @ (P @ A) - G.T @ K
        Ks[t], Hs[t], Gs[t], Ps[t] = K, H, G, P
        P = 0.5 * (P_new + P_new.T)
    return RiccatiFactorization(K=torch.stack(Ks), H=torch.stack(Hs),
                                G=torch.stack(Gs),
                                P=torch.stack([P] + Ps))


def riccati_linear(prob: LqrProblem, fac: RiccatiFactorization) -> LqrGains:
    """The (k, p) recursion of ``riccati_backward_plain`` with (K, H, G, P)
    taken from ``fac``."""
    T = prob.B.shape[0]
    p = prob.qf
    ks, ps = [None] * T, [None] * T
    for t in reversed(range(T)):
        Pc_p = fac.P[t + 1] @ prob.c[t] + p
        g = prob.r[t] + prob.B[t].T @ Pc_p
        k = solve_spd(fac.H[t], g)
        ks[t], ps[t] = k, p
        p = prob.q[t] + prob.A[t].T @ Pc_p - fac.G[t].T @ k
    return LqrGains(K=fac.K, k=torch.stack(ks), P=fac.P,
                    p=torch.stack([p] + ps))


def lqr_rollout_linear(prob: LqrProblem, gains: LqrGains):
    """Roll the *linear* model under the affine feedback: the QP optimum.

    Returns (x_trj (T+1,n), u_trj (T,m))."""
    x = prob.x0
    xs, us = [x], []
    for t in range(prob.B.shape[0]):
        u = -(gains.K[t] @ x + gains.k[t])
        x = prob.A[t] @ x + prob.B[t] @ u + prob.c[t]
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)


def lqr_solve(prob: LqrProblem, backend: str = "auto",
              parallel: bool = False):
    """Solve the unconstrained affine-quadratic problem exactly.
    Returns (x_trj, u_trj, gains).

    "auto": CUDA tensors make one launch of the kernel, backward pass and
    plan (P and p stay on chip, None); CPU tensors run
    ``riccati_backward_plain`` and ``lqr_rollout_linear``.  ``parallel``
    (or backend "assoc") runs ``riccati_backward_assoc`` and
    ``lqr_rollout_linear`` on either device."""
    _check_backend(backend)
    if parallel:
        backend = "assoc"
    if backend == "auto" and _nvcc.on_card(prob.A):
        x_trj, u_trj, K, k = cuda_riccati.lqr_solve_cuda(
            LqrProblem(*(a.contiguous() for a in prob)))
        return x_trj, u_trj, LqrGains(K=K, k=k, P=None, p=None)
    gains = riccati_backward(prob, backend)
    x_trj, u_trj = lqr_rollout_linear(prob, gains)
    return x_trj, u_trj, gains


# ---------------------------------------------------------------------------
# Problem builders
# ---------------------------------------------------------------------------

def build_tracking_problem(A, B, c, Q, Qd, R, x0, xd_trj) -> LqrProblem:
    """Tracking problem: cost (x-xd)'Q(x-xd) + u'Ru, final Qd."""
    T, n, m = B.shape
    return LqrProblem(
        A=A, B=B, c=c,
        Q=Q.expand(T, n, n),
        R=R.expand(T, m, m),
        N=A.new_zeros((T, n, m)),
        q=-(xd_trj[:-1] @ Q.T),
        r=A.new_zeros((T, m)),
        Qf=Qd,
        qf=-(Qd @ xd_trj[-1]),
        x0=x0,
    )


def build_delta_u_problem(A, B, c, Q, Qd, R, x0, xd_trj,
                          indices_u_into_x) -> LqrProblem:
    """Δu-cost problem via prev-input state augmentation.

    The state is z = [x; w] with w_t = u_{t-1} (w_0 = x_0[indices_u]), so
    the cost R on du = u_t - u_{t-1} becomes stage-quadratic with a cross
    term: (u - w)'R(u - w) = u'Ru - 2 w'Ru + w'Rw.  Returns an augmented
    problem of dim n+m; ``split_augmented`` recovers the x trajectory."""
    T, n, m = B.shape
    na = n + m
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)

    A_aug = A.new_zeros((T, na, na))
    A_aug[:, :n, :n] = A
    B_aug = A.new_zeros((T, na, m))
    B_aug[:, :n, :] = B
    B_aug[:, n:, :] = eye_m
    c_aug = A.new_zeros((T, na))
    c_aug[:, :n] = c

    # Stage cost: x-tracking Q + w'Rw + u'Ru - 2 w'Ru.
    Q_aug = A.new_zeros((T, na, na))
    Q_aug[:, :n, :n] = Q
    Q_aug[:, n:, n:] = R
    N_aug = A.new_zeros((T, na, m))
    N_aug[:, n:, :] = -R
    q_aug = A.new_zeros((T, na))
    q_aug[:, :n] = -(xd_trj[:-1] @ Q.T)

    Qf_aug = A.new_zeros((na, na))
    Qf_aug[:n, :n] = Qd
    qf_aug = A.new_zeros((na,))
    qf_aug[:n] = -(Qd @ xd_trj[-1])

    return LqrProblem(
        A=A_aug, B=B_aug, c=c_aug,
        Q=Q_aug, R=R.expand(T, m, m), N=N_aug,
        q=q_aug, r=A.new_zeros((T, m)),
        Qf=Qf_aug, qf=qf_aug,
        x0=torch.cat([x0, x0[indices_u_into_x]]))


def build_prev_u_tracking_problem(A, B, c, Q, Qd, R, x0,
                                  xd_trj) -> LqrProblem:
    """Tracking problem (plain u'Ru cost) with a prev-input augmented state
    z = [x; w], w_t = u_{t-1}, so that relative input bounds can box u - w.
    w_0 is 0 and carries no cost."""
    T, n, m = B.shape
    na = n + m

    A_aug = A.new_zeros((T, na, na))
    A_aug[:, :n, :n] = A
    B_aug = A.new_zeros((T, na, m))
    B_aug[:, :n, :] = B
    B_aug[:, n:, :] = torch.eye(m, dtype=A.dtype, device=A.device)
    c_aug = A.new_zeros((T, na))
    c_aug[:, :n] = c

    Q_aug = A.new_zeros((T, na, na))
    Q_aug[:, :n, :n] = Q
    q_aug = A.new_zeros((T, na))
    q_aug[:, :n] = -(xd_trj[:-1] @ Q.T)
    Qf_aug = A.new_zeros((na, na))
    Qf_aug[:n, :n] = Qd
    qf_aug = A.new_zeros((na,))
    qf_aug[:n] = -(Qd @ xd_trj[-1])

    return LqrProblem(
        A=A_aug, B=B_aug, c=c_aug,
        Q=Q_aug, R=R.expand(T, m, m), N=A.new_zeros((T, na, m)),
        q=q_aug, r=A.new_zeros((T, m)),
        Qf=Qf_aug, qf=qf_aug,
        x0=torch.cat([x0, A.new_zeros((m,))]))


def split_augmented(x_aug_trj: Tensor, n: int) -> Tensor:
    """Recover the physical state trajectory from an augmented solution."""
    return x_aug_trj[:, :n]
