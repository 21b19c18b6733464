"""The plain quasistatic contact step of the reference (Anitescu convex
time-stepping), the same for every contact configuration; each
configuration's file gives its masses, stiffnesses and contacts.

One step solves, over the configuration change dq,

    min 1/2 dq'P dq + b'dq   s.t.   G dq >= -phi   (two rows per contact)

with P = diag(stiffness on actuated dofs, mass / h^2 on the others),
b = stiffness (q - u) on actuated dofs and minus the gravity force on the
others, and steps q + dq*.  A serial rollout warm-starts each knot's solve
from the previous knot's; the Jacobian of the step is the implicit one of
the relaxed KKT system, with the duals' sensitivity lam / s capped.
"""
from __future__ import annotations

import torch

from . import geometry
from .arith import W_CAP, pdip, solve_spd


class QuasistaticReference:
    """A configuration's contact model; subclasses set ``masses``
    (unactuated dof -> mass), ``gravity_force`` (dof -> mass times
    gravity), ``stiffness`` (actuated dof -> stiffness) and
    ``contacts(q)``."""
    masses: dict
    gravity_force: dict
    stiffness: dict

    def __init__(self, config: dict, ar):
        self.ar = ar
        self.nq, self.m = config["nq"], config["m"]
        self.h = config["factory_args"]["h"]
        self.mu = config["factory_args"]["mu"]
        self.qp_iters = config["qp_iters"]
        self.qp_iters_ws = config["qp_iters_ws"]
        self.idx_u = [i for g in config["actuated"]
                      for i in config["layout"][g]]
        if sorted(self.idx_u) != sorted(self.stiffness):
            raise ValueError("the configuration's actuated dofs are not the "
                             "reference model's")
        diag = [self.stiffness[i] if i in self.stiffness
                else self.masses[i] / self.h ** 2 for i in range(self.nq)]
        self.P = torch.diag(ar(diag))
        # d b / d(q, u): stiffness on the actuated dofs' q, minus it on u.
        self.db = torch.zeros((self.nq, self.nq + self.m),
                              dtype=ar.dtype, device=ar.device)
        for j, i in enumerate(self.idx_u):
            self.db[i, i] = self.stiffness[i]
            self.db[i, self.nq + j] = -self.stiffness[i]
        self.rows = self.contact_rows(ar(torch.zeros(self.nq)))[0].shape[-2]

    def contacts(self, q):
        """[(phi, p, n, J_a, J_b)] of every contact at q."""
        raise NotImplementedError

    def axes(self, q):
        """The unit columns e_y, e_z of a point Jacobian, as (..., 2)."""
        eye = torch.eye(2, dtype=q.dtype, device=q.device)
        shape = q.shape[:-1] + (2,)
        return eye[0].expand(shape), eye[1].expand(shape)

    def contact_rows(self, q):
        """G (..., rows, nq), phi (..., rows): G dq >= -phi."""
        return geometry.contact_rows(self.contacts(q), q, self.mu)

    def qp(self, q, u):
        """(P, b, C, d) of the step QP, in the solver's C dq <= d form."""
        cols = []
        for i in range(self.nq):
            if i in self.stiffness:
                j = self.idx_u.index(i)
                cols.append(self.stiffness[i] * (q[..., i] - u[..., j]))
            else:
                cols.append(torch.zeros_like(q[..., i])
                            - self.gravity_force.get(i, 0.0))
        G, phi = self.contact_rows(q)
        return (self.P.expand(q.shape[:-1] + self.P.shape),
                torch.stack(cols, dim=-1), -G, phi)

    def step(self, x, u, iters):
        """The cold step at ``iters`` PDIP iterations, over batch dims."""
        return x + pdip(self.ar, *self.qp(x, u), iters)[0]

    def step_warm(self, x, u, carry):
        """The warm-started step of a rollout chain: ``qp_iters_ws``
        iterations from the previous knot's (dq, lam); returns (x_next,
        carry)."""
        dq, _, lam = pdip(self.ar, *self.qp(x, u), self.qp_iters_ws,
                          init=carry)
        lam = torch.where(torch.isfinite(lam), lam, torch.ones_like(lam))
        return x + dq, (dq, lam)

    def carry0(self):
        """The warm start of a chain's first knot: dq = 0, duals 1."""
        return (self.ar(torch.zeros(self.nq)),
                self.ar(torch.ones(self.rows)))

    def rollout(self, x0, u_trj):
        """Open-loop warm chains: (n,), (..., T, m) -> (..., T+1, n)."""
        x = x0.expand(u_trj.shape[:-2] + x0.shape)
        carry, xs = self.carry0(), [x]
        for t in range(u_trj.shape[-2]):
            x, carry = self.step_warm(x, u_trj[..., t, :], carry)
            xs.append(x)
        return torch.stack(xs, dim=-2)

    def jacobian(self, x, u):
        """(x_next (T, n), [dx_next/dx | dx_next/du] (T, n, n+m)) of the
        cold step at ``qp_iters`` at T points: the forward solve, then the
        implicit derivative of the relaxed KKT system at its solution."""
        ar, n = self.ar, self.nq
        P, b, C, d = self.qp(x, u)
        dq, s, lam = pdip(ar, P, b, C, d, self.qp_iters)
        dG, dphi = torch.func.vmap(torch.func.jacfwd(self.contact_rows))(x)
        # Forward mode can widen a tangent to float64; the reference
        # computes in its own dtype.
        dG, dphi = dG.to(ar.dtype), dphi.to(ar.dtype)
        pad = (0, self.m)
        dC = torch.nn.functional.pad(-dG, pad)        # (T, rows, n, n+m)
        dd = torch.nn.functional.pad(dphi, pad)       # (T, rows, n+m)
        D = torch.clamp(lam / torch.clamp(s, min=1e-8), max=W_CAP)
        H = P + ar.mm(C.transpose(-1, -2) * D.unsqueeze(-2), C) \
            + 1e-10 * ar.eye(n)
        rhs = -(self.db + ar.ein("trik,tr->tik", dC, lam)) \
            + ar.ein("tri,trk->tik", C,
                     D[..., None] * (dd - ar.ein("trik,ti->trk", dC, dq)))
        J = solve_spd(H, rhs)
        J[:, :, :n] += ar.eye(n)
        return x + dq, J
