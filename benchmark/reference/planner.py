"""The plain reference of one planner iteration, from the inputs the
benchmark hands it: the problem, the nominal trajectory the iteration
starts from, its 1-based index and its random draws.

iRS (``irs_iteration``): the smoothed linearisation (zero_order_B: B_t by
least squares over input samples, each a cold contact step at the
surrogate's PDIP iterations against the nominal step at the full count;
exact: the step's implicit Jacobian), A_t and the actuated rows of B_t
pinned by ``decouple``, the Δu-augmented tracking problem, the boxed
trajectory QP by factored ADMM sweeps on a Riccati recursion, then the
line search: every step size's feedback rollout of the true dynamics
through warm chains, clipped to the input bounds, and each lane's cost.

CEM (``cem_step``): the AR(1)-correlated population about the mean, the
persisted elites, every candidate's open-loop warm chain and cost, the
elites' refit with momentum, the refit mean's chain and cost, the
divergence guard and the std floor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import traffic
from .arith import solve_spd


class Lqr(NamedTuple):
    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    N: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    Qf: torch.Tensor
    qf: torch.Tensor
    x0: torch.Tensor


class Linear(NamedTuple):
    A: torch.Tensor         # (T, n, n)
    B: torch.Tensor         # (T, n, m)
    c: torch.Tensor         # (T, n)
    f_nom: torch.Tensor     # (T, n) the nominal's steps


class Lanes(NamedTuple):
    costs: torch.Tensor     # (A, 6): total, Qu, Qu_final, Qa, Qa_final, R
    xs: torch.Tensor        # (A, T+1, n)
    us: torch.Tensor        # (A, T, m)


class CemOut(NamedTuple):
    costs: torch.Tensor     # (B,) the population's, +inf where not finite
    x: torch.Tensor         # (T+1, n) the accepted mean's trajectory
    u: torch.Tensor         # (T, m) the accepted mean
    cost: torch.Tensor      # () its cost
    std: torch.Tensor       # (T, m)


class Planner:
    """The reference planner of a configuration: ``model`` (its
    ``QuasistaticReference``), the configuration's file and a plan's
    problem (``problem.Problem``)."""

    def __init__(self, model, config: dict, prob):
        ar = self.ar = model.ar
        self.model, self.config = model, config
        self.n, self.m, self.T = config["nq"], config["m"], config["T"]
        self.x0, self.xd = ar(prob.x0), ar(prob.xd_trj)
        self.Q, self.Qd, self.R = ar(prob.Q), ar(prob.Qd), ar(prob.R)
        self.idx_u = torch.as_tensor(prob.idx_u, device=ar.device)
        self.mask_u = ar(torch.zeros(self.n))
        self.mask_u[torch.as_tensor(prob.unactuated)] = 1.0
        self.rel = None if prob.u_bounds_rel is None else ar(prob.u_bounds_rel)
        self.box = None if prob.u_bounds_abs is None else ar(prob.u_bounds_abs)
        self.trust = config["bounds_trust_region"]
        self.final_Q = config["report_final_cost_with_Q"]

    # ---- cost -----------------------------------------------------------
    def _quad(self, e, M):
        return self.ar.ein("...i,ij,...j->...", e, M, e)

    def cost(self, x, u):
        """(total, Qu, Qu_final, Qa, Qa_final, R) of x (..., T+1, n),
        u (..., T, m), each (...): the state cost with Q (the final state's
        with Qd), split into the unactuated and actuated dofs, and the Δu
        cost with du_0 = u_0 - x_0[idx_u]."""
        ex = x[..., :-1, :] - self.xd[:-1]
        ef = x[..., -1, :] - self.xd[-1]
        Qf = self.Q if self.final_Q else self.Qd
        cx, cxf = self._quad(ex, self.Q).sum(-1), self._quad(ef, Qf)
        cu = self._quad(ex * self.mask_u, self.Q).sum(-1)
        cuf = self._quad(ef * self.mask_u, Qf)
        u_prev = torch.cat([x[..., :1, self.idx_u], u[..., :-1, :]], dim=-2)
        cr = self._quad(u - u_prev, self.R).sum(-1)
        return torch.stack([cu + (cx - cu) + cuf + (cxf - cuf) + cr,
                            cu, cuf, cx - cu, cxf - cuf, cr], dim=-1)

    # ---- estimation -------------------------------------------------------
    def _fit(self, S, D):
        """Least squares D ~ S Theta by the normal equations with a tiny
        ridge, batched over knots; returns Theta' (..., n, p)."""
        ar = self.ar
        p = S.shape[-1]
        St = S.transpose(-1, -2)
        G, M = ar.mm(St, S), ar.mm(St, D)
        eps = 1e-9 * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / p + 1e-12
        return solve_spd(G + eps[..., None, None] * ar.eye(p),
                         M).transpose(-1, -2)

    def linearise(self, mode, x_trj, u_trj, it, draws) -> Linear:
        """The decoupled linearisation along the nominal, with its steps."""
        ar, model, cfg = self.ar, self.model, self.config
        x_nom = x_trj[:-1]
        if mode == "exact":
            f_nom, J = model.jacobian(x_nom, u_trj)
            B = J[:, :, self.n:]
        elif mode == "zero_order_B":
            sm = cfg["smoothing"]
            scale = traffic.decay(sm["decay"], float(np.float32(it)))
            du = ar(draws[1]) * (sm["std_u"] * scale)
            f_nom = model.step(x_nom, u_trj, model.qp_iters)
            T, S = du.shape[:2]
            fd = model.step(x_nom[:, None].expand(T, S, self.n),
                            u_trj[:, None] + du, cfg["surrogate_qp_iters"])
            B = self._fit(du, fd - f_nom[:, None])
        else:
            raise ValueError(f"no reference for gradient mode {mode!r}")
        # decouple: A = I without the actuated columns; actuated rows of B
        # pinned to the identity; c from the nominal steps.
        A = ar.eye(self.n).expand(self.T, self.n, self.n).clone()
        A[:, :, self.idx_u] = 0.0
        B = B.clone()
        B[:, self.idx_u, :] = ar.eye(self.m)
        c = (f_nom - ar.ein("tij,tj->ti", A, x_nom)
             - ar.ein("tij,tj->ti", B, u_trj))
        return Linear(A, B, c, f_nom)

    # ---- the trajectory QP ----------------------------------------------
    def problem(self, A, B, c):
        """The Δu-augmented tracking problem, state z = [x; w], w_t =
        u_{t-1}, w_0 = x_0[idx_u]."""
        ar, T, n, m = self.ar, self.T, self.n, self.m
        na = n + m

        def zeros(*shape):
            return torch.zeros(shape, dtype=ar.dtype, device=ar.device)

        A_aug, B_aug, c_aug = zeros(T, na, na), zeros(T, na, m), zeros(T, na)
        A_aug[:, :n, :n], B_aug[:, :n], B_aug[:, n:] = A, B, ar.eye(m)
        c_aug[:, :n] = c
        Q_aug, N_aug, q_aug = zeros(T, na, na), zeros(T, na, m), zeros(T, na)
        Q_aug[:, :n, :n], Q_aug[:, n:, n:] = self.Q, self.R
        N_aug[:, n:] = -self.R
        q_aug[:, :n] = -ar.mm(self.xd[:-1], self.Q.T)
        Qf, qf = zeros(na, na), zeros(na)
        Qf[:n, :n] = self.Qd
        qf[:n] = -ar.mv(self.Qd, self.xd[-1])
        return Lqr(A_aug, B_aug, c_aug, Q_aug, self.R.expand(T, m, m), N_aug,
                   q_aug, zeros(T, m), Qf, qf,
                   torch.cat([self.x0, self.x0[self.idx_u]]))

    def _riccati(self, p: Lqr):
        """The factored Riccati recursion: (K, H, G, P) per knot."""
        ar = self.ar
        P = p.Qf
        Ks, Hs, Gs, Ps = [], [], [], []
        for t in reversed(range(self.T)):
            A, B = p.A[t], p.B[t]
            H = p.R[t] + ar.mm(B.T, ar.mm(P, B))
            G = p.N[t].T + ar.mm(B.T, ar.mm(P, A))
            K = solve_spd(H, G)
            P_new = p.Q[t] + ar.mm(A.T, ar.mm(P, A)) - ar.mm(G.T, K)
            Ks.append(K), Hs.append(H), Gs.append(G), Ps.append(P)
            P = 0.5 * (P_new + P_new.T)
        Ps.append(P)
        rev = lambda xs: torch.stack(xs[::-1])   # noqa: E731
        return rev(Ks), rev(Hs), rev(Gs), rev(Ps)

    def _solve(self, p: Lqr, fac):
        """The affine recursion and the linear plan of ``p`` on ``fac``:
        (z (T+1, na), u (T, m), K, k)."""
        ar = self.ar
        K, H, G, Pm = fac
        pv = p.qf
        ks = [None] * self.T
        for t in reversed(range(self.T)):
            Pc_p = ar.mv(Pm[t + 1], p.c[t]) + pv
            g = p.r[t] + ar.mv(p.B[t].T, Pc_p)
            ks[t] = solve_spd(H[t], g)
            pv = p.q[t] + ar.mv(p.A[t].T, Pc_p) - ar.mv(G[t].T, ks[t])
        z, zs, us = p.x0, [p.x0], []
        for t in range(self.T):
            u = -(ar.mv(K[t], z) + ks[t])
            z = ar.mv(p.A[t], z) + ar.mv(p.B[t], u) + p.c[t]
            zs.append(z), us.append(u)
        return torch.stack(zs), torch.stack(us), K, torch.stack(ks)

    def boxes(self, x_trj):
        """{kind: (lb, ub)} of the trajectory QP: Δu boxes from the
        relative bounds; u boxes from the absolute ones, about the nominal's
        actuated dofs under the trust region."""
        T, m = self.T, self.m
        out = {}
        if self.rel is not None:
            out["du"] = (self.rel[0].expand(T, m), self.rel[1].expand(T, m))
        if self.box is not None:
            centre = (x_trj[:-1, self.idx_u] if self.trust
                      else torch.zeros_like(x_trj[:-1, self.idx_u]))
            out["u"] = (centre + self.box[0], centre + self.box[1])
        return out

    def admm(self, p: Lqr, boxes, iters, rho, a):
        """The boxed QP: the unconstrained solve projected onto the boxes
        starts z; each sweep solves the problem with the penalties rho
        |s - (z - y)|^2 on the factored Riccati recursion, then z = clip(a s
        + (1 - a) z + y), y += a s + (1 - a) z - z.  Returns (z, u, K)."""
        ar, n, m = self.ar, self.n, self.m
        W = torch.zeros((m, n + m), dtype=ar.dtype, device=ar.device)
        W[:, n:] = ar.eye(m)

        def stage(z_trj, u_trj):
            return {"u": u_trj, "du": u_trj - z_trj[:-1, n:]}

        zt, ut, _, _ = self._solve(p, self._riccati(p))
        s0 = stage(zt, ut)
        zc = {k: torch.minimum(torch.maximum(s0[k], lb), ub)
              for k, (lb, ub) in boxes.items()}
        y = {k: torch.zeros_like(v) for k, v in zc.items()}
        # The quadratic penalties, the same every sweep.
        Qp, Rp, Np = p.Q, p.R, p.N
        if "u" in boxes:
            Rp = Rp + rho * ar.eye(m)
        if "du" in boxes:
            Qp = Qp + rho * ar.mm(W.T, W)
            Rp = Rp + rho * ar.eye(m)
            Np = Np - rho * W.T
        pen = p._replace(Q=Qp, R=Rp.expand(self.T, m, m),
                         N=Np.expand(self.T, n + m, m))
        fac = self._riccati(pen)
        for _ in range(int(iters)):
            q, r = p.q, p.r
            if "u" in boxes:
                r = r - rho * (zc["u"] - y["u"])
            if "du" in boxes:
                v = zc["du"] - y["du"]
                q = q + rho * ar.mm(v, W)
                r = r - rho * v
            zt, ut, K, _ = self._solve(pen._replace(q=q, r=r), fac)
            s = stage(zt, ut)
            for k, (lb, ub) in boxes.items():
                sh = a * s[k] + (1.0 - a) * zc[k]
                znew = torch.minimum(torch.maximum(sh + y[k], lb), ub)
                y[k] = y[k] + sh - znew
                zc[k] = znew
        return zt, ut, K

    # ---- the line search ------------------------------------------------
    def lanes(self, x_trj, u_trj, K, z_plan, u_plan, alphas):
        """Every step size's feedback rollout of the true dynamics, u_t =
        u_ref - K_t (z_t - z_ref), clipped to the relative then the
        absolute input bounds, through warm chains; with their costs."""
        ar, model, n, T = self.ar, self.model, self.n, self.T
        a = ar(alphas)[:, None, None]
        u_prev0 = x_trj[0, self.idx_u]
        z_nom = torch.cat([x_trj[:-1],
                           torch.cat([u_prev0[None], u_trj[:-1]])], dim=1)
        z_ref = z_nom + a * (z_plan[:-1] - z_nom)
        u_ref = u_trj + a * (u_plan - u_trj)
        if self.box is not None:
            centre = (x_trj[:-1, self.idx_u] if self.trust
                      else torch.zeros_like(u_trj))
            lb, ub = centre + self.box[0], centre + self.box[1]
        L = u_ref.shape[0]
        x = self.x0.expand(L, n)
        u_prev = u_prev0.expand(L, self.m)
        carry, xs, us = model.carry0(), [x], []
        for t in range(T):
            z = torch.cat([x, u_prev], dim=1)
            u = u_ref[:, t] - ar.mm(z - z_ref[:, t], K[t].T)
            if self.rel is not None:
                u = torch.minimum(torch.maximum(u, u_prev + self.rel[0]),
                                  u_prev + self.rel[1])
            if self.box is not None:
                u = torch.minimum(torch.maximum(u, lb[t]), ub[t])
            x, carry = model.step_warm(x, u, carry)
            xs.append(x), us.append(u)
            u_prev = u
        xs, us = torch.stack(xs, dim=1), torch.stack(us, dim=1)
        return Lanes(self.cost(xs, us), xs, us)

    def descend(self, x_trj, u_trj, A, B, c) -> Lanes:
        """The boxed LQR on the linearisation (A, B, c) along the nominal
        (x_trj, u_trj), then the line search."""
        cfg = self.config
        z_plan, u_plan, K = self.admm(self.problem(A, B, c),
                                      self.boxes(x_trj), cfg["admm_iters"],
                                      cfg["admm_rho"], cfg["admm_over_relax"])
        return self.lanes(x_trj, u_trj, torch.nan_to_num(K),
                          torch.nan_to_num(z_plan), torch.nan_to_num(u_plan),
                          cfg["line_search_alphas"])

    def irs_iteration(self, mode, x_trj, u_trj, it, draws):
        """One iRS iteration from the nominal (x_trj, u_trj): its
        linearisation and its lanes."""
        lin = self.linearise(mode, x_trj, u_trj, it, draws)
        return lin, self.descend(x_trj, u_trj, lin.A, lin.B, lin.c)

    def start(self, u_init):
        """The initial guess's trajectory and cost (a plan's constructor)."""
        x = self.model.rollout(self.x0, u_init)
        return x, self.cost(x, u_init)[0]

    # ---- CEM --------------------------------------------------------------
    def cem_cost(self, x, u):
        """CEM's cost: the state cost and the Δu cost, one number."""
        return self.cost(x, u)[..., 0]

    def cem_step(self, u_trj, std_trj, prev_x, prev_cost,
                 kept: Optional[torch.Tensor], noise) -> CemOut:
        """One CEM iteration from the mean ``u_trj`` and ``std_trj``, with
        the raw standard-normal draw ``noise`` (B, T, m)."""
        ar, cem = self.ar, self.config["cem"]
        beta = cem["noise_beta"]
        raw = ar(noise)
        e, out = raw[:, 0], [raw[:, 0]]
        for t in range(1, self.T):
            e = beta * e + float(np.sqrt(1.0 - beta * beta)) * raw[:, t]
            out.append(e)
        cand = u_trj[None] + std_trj[None] * torch.stack(out, dim=1)
        k = cem["elite_keep"]
        if kept is not None:
            cand = torch.cat([kept, cand[k:]], dim=0)
        xs = self.model.rollout(self.x0, cand)
        costs = self.cem_cost(xs, cand)
        costs = torch.where(torch.isfinite(costs), costs, torch.inf)
        elite_idx = torch.topk(costs, cem["n_elite"], largest=False).indices
        elites = cand[elite_idx]
        mom = cem["momentum"]
        u_new = (1 - mom) * elites.mean(0) + mom * u_trj
        std_new = (1 - mom) * elites.std(0, correction=0) + mom * std_trj
        x_new = self.model.rollout(self.x0, u_new[None])[0]
        cost_new = self.cem_cost(x_new, u_new)
        best = elite_idx[0]
        if not torch.isfinite(cost_new):
            if torch.isfinite(costs[best]):
                u_new, x_new, cost_new = cand[best], xs[best], costs[best]
                std_new = 0.5 * std_trj
            else:
                u_new, x_new, cost_new = u_trj, prev_x, prev_cost
                std_new = std_trj
        std_new = torch.maximum(std_new, ar(cem["std_floor"]))
        return CemOut(costs, x_new, u_new, cost_new, std_new)
