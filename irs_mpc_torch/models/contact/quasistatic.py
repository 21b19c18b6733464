"""Differentiable quasistatic contact dynamics (Anitescu convex time-stepping).

The counterpart of the JAX package's ``models/contact/quasistatic.py``:
position-controlled robots with stiffness Kp, quasi-dynamic unactuated
objects, friction by the Anitescu cone discretisation (two rows per contact
in 2D), one convex QP per step over the configuration change dq:

    min_dq  1/2 dq_a' Kp dq_a + (Kp (q_a - u))' dq_a        [elastic energy]
          + 1/2 dq_u' (M_u / h^2) dq_u - tau_ext' dq_u       [quasi-dynamic]
    s.t.    (J_n +- mu J_t) dq >= -phi_c   for every contact c

    q_next = q + dq*.

Every method works over leading batch dims.  The device picks the solver of
the batched sweeps: CUDA tensors go through kernel K2 (``cuda_qp``), CPU
tensors through the plain batched PDIP; the whole-chain line search of a
supported model goes through kernel K4 (``cuda_rollout``) on CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..base import System
from . import geometry as geom
from .qp import solve_qp, solve_qp_warm

Tensor = torch.Tensor


def _on_device(diag: np.ndarray, device, dtype) -> Tensor:
    """diag(``diag``) on ``device``, made once for each value and shared
    by every caller (never write to it): a copy from the host would wait
    on the device's queue at every step."""
    return _cached_diag(tuple(diag.tolist()), device, dtype)


@functools.lru_cache(maxsize=None)
def _cached_diag(diag, device, dtype) -> Tensor:
    return torch.diag(torch.tensor(diag, dtype=torch.float32)).to(device,
                                                                   dtype)


@dataclasses.dataclass(frozen=True)
class ModelInstance:
    """A named group of dofs, the analogue of a Drake model instance."""
    name: str
    q_indices: Tuple[int, ...]
    actuated: bool
    # actuated: per-dof stiffness Kp; unactuated: per-dof mass/inertia.
    stiffness: Optional[Tuple[float, ...]] = None
    mass: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class ContactPair:
    """Collision candidate between two bodies' shapes (static enumeration).
    For an Arm2D body the shape index is the link index."""
    body_a: int
    body_b: int
    shape_a: int = 0
    shape_b: int = 0
    mu: float = 0.5


@dataclasses.dataclass(frozen=True)
class QuasistaticModel:
    """Static description of a quasistatic system; ``step`` is pure.  The
    fields are those of the JAX package's model (see its docstrings for
    ``qp_iters_ws``, ``contact_model`` and ``canon_warm_duals``)."""
    name: str
    h: float
    nq: int
    models: Tuple[ModelInstance, ...]
    bodies: Tuple[geom.BodyBase, ...]
    pairs: Tuple[ContactPair, ...]
    gravity: Tuple[float, float] = (0.0, -10.0)
    qp_iters: int = 30
    # Warm-started iterations per knot of a serial rollout chain; 0
    # disables warm rollouts.
    qp_iters_ws: int = 10
    # "anitescu" (convex relaxation, every pair contributes cone rows) or
    # "lcp" (only touching pairs, rows G dq >= 0).
    contact_model: str = "anitescu"
    # Replace each contact's two warm-start duals by their mean after every
    # knot of a rollout chain (opt-in; see the JAX package).
    canon_warm_duals: bool = False

    def __post_init__(self):
        if self.contact_model not in ("anitescu", "lcp"):
            raise ValueError(
                f"contact_model {self.contact_model!r} not in "
                f"('anitescu', 'lcp')")

    # ---- bookkeeping ------------------------------------------------------

    @property
    def dim_x(self) -> int:
        return self.nq

    @property
    def dim_u(self) -> int:
        return sum(len(m.q_indices) for m in self.models if m.actuated)

    @property
    def models_actuated(self):
        return [m for m in self.models if m.actuated]

    @property
    def models_unactuated(self):
        return [m for m in self.models if not m.actuated]

    def indices_u_into_x(self) -> np.ndarray:
        out = []
        for m in self.models_actuated:
            out.extend(m.q_indices)
        return np.asarray(out, np.int64)

    def get_q_dict_from_x(self, x) -> Dict[str, Tensor]:
        return {m.name: x[..., list(m.q_indices)] for m in self.models}

    def get_x_from_q_dict(self, q_dict: Dict[str, np.ndarray]) -> np.ndarray:
        x = np.zeros(self.nq, np.float32)
        for m in self.models:
            x[list(m.q_indices)] = np.asarray(q_dict[m.name])
        return x

    def get_u_from_q_cmd_dict(self, q_cmd: Dict[str, np.ndarray]
                              ) -> np.ndarray:
        return np.concatenate([np.asarray(q_cmd[m.name])
                               for m in self.models_actuated]
                              ).astype(np.float32)

    def get_Q_from_Q_dict(self, Q_dict: Dict[str, np.ndarray]) -> np.ndarray:
        Q = np.zeros((self.nq, self.nq), np.float32)
        for m in self.models:
            idx = np.asarray(m.q_indices)
            Q[idx, idx] = np.asarray(Q_dict[m.name])
        return Q

    def get_R_from_R_dict(self, R_dict: Dict[str, np.ndarray]) -> np.ndarray:
        v = np.concatenate([np.asarray(R_dict[m.name])
                            for m in self.models_actuated]).astype(np.float32)
        return np.diag(v)

    # ---- QP assembly ------------------------------------------------------

    def _hessian_and_bias(self, q: Tensor, u: Tensor):
        """P (..., nq, nq) diagonal and b (..., nq) of the step QP."""
        p_diag = np.zeros(self.nq, np.float32)
        cols = [None] * self.nq
        zero = torch.zeros_like(q[..., 0])
        g = np.asarray(self.gravity, np.float32)
        iu = 0
        for m in self.models:
            if m.actuated:
                kp = np.asarray(m.stiffness, np.float32)
                for j, qi in enumerate(m.q_indices):
                    p_diag[qi] = kp[j]
                    cols[qi] = float(kp[j]) * (q[..., qi] - u[..., iu + j])
                iu += len(m.q_indices)
            else:
                mass = np.asarray(m.mass, np.float32)
                p_diag[list(m.q_indices)] = mass / np.float32(self.h ** 2)
                # Gravity on the translation dofs of a free body (its first
                # two dofs); rotation dofs get none.
                tau = np.zeros(len(m.q_indices), np.float32)
                if len(m.q_indices) >= 2:
                    tau[:2] = mass[:2] * g
                for j, qi in enumerate(m.q_indices):
                    cols[qi] = zero - float(tau[j])
        P = _on_device(p_diag, q.device, q.dtype)
        return P.expand(q.shape[:-1] + P.shape), torch.stack(cols, dim=-1)

    def _body_point_jacobian(self, body_idx: int, q, p, shape_idx: int):
        body = self.bodies[body_idx]
        if isinstance(body, geom.Arm2D):
            # Shape k of an Arm2D is its k-th link capsule.
            return body.point_jacobian_link(q, p, shape_idx)
        return body.point_jacobian(q, p)

    def contact_rows(self, q: Tensor):
        """All contact constraint rows: G (..., rows, nq), phi (..., rows),
        with the constraint set G dq >= -phi (two Anitescu rows per contact
        point), or (None, None) without pairs."""
        Gs, phis = [], []
        for pair in self.pairs:
            sa = self.bodies[pair.body_a].world_shapes(q)[pair.shape_a]
            sb = self.bodies[pair.body_b].world_shapes(q)[pair.shape_b]
            for phi, p, n in geom.shape_contact(sa, sb):
                Ja = self._body_point_jacobian(pair.body_a, q, p,
                                               pair.shape_a)
                Jb = self._body_point_jacobian(pair.body_b, q, p,
                                               pair.shape_b)
                Jrel = Jb - Ja                              # (..., 2, nq)
                t = geom._perp(n)
                Jn = (n[..., :, None] * Jrel).sum(-2)
                Jt = (t[..., :, None] * Jrel).sum(-2)
                Gs += [Jn + pair.mu * Jt, Jn - pair.mu * Jt]
                phis += [phi, phi]
        if not Gs:
            return None, None
        return torch.stack(Gs, dim=-2), torch.stack(phis, dim=-1)

    # ---- the step -----------------------------------------------------------

    def _constraint_rows(self, q: Tensor):
        """Contact rows in the solver's C dq <= d form, per contact_model."""
        G, phi = self.contact_rows(q)
        if G is None:
            return None, None
        if self.contact_model == "lcp":
            # Separated pairs are vacuous rows 0'dq <= 1; touching or
            # penetrating pairs block relative motion (G dq >= 0).
            active = phi <= 0.0
            C = torch.where(active[..., None], -G, torch.zeros_like(G))
            d = torch.where(active, torch.zeros_like(phi),
                            torch.ones_like(phi))
            return C, d
        return -G, phi

    def _free_step(self, P, b):
        eye = torch.eye(self.nq, dtype=P.dtype, device=P.device)
        return -torch.linalg.solve(P + 1e-9 * eye, b.unsqueeze(-1))[..., 0]

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        """One quasistatic step: q_next = q + argmin QP, over leading batch
        dims.  Differentiable in forward mode (``torch.func.jacfwd``)."""
        P, b = self._hessian_and_bias(x, u)
        C, d = self._constraint_rows(x)
        if C is None:
            return x + self._free_step(P, b)
        return x + solve_qp(P, b, C, d, self.qp_iters)

    def n_constraint_rows(self) -> int:
        """Static number of contact rows (fixed by the pair list)."""
        G, _ = self.contact_rows(torch.zeros(self.nq))
        return 0 if G is None else G.shape[-2]

    def ws_init(self, device="cpu"):
        """Initial warm-start carry of a rollout chain: (dq, lam) = (0, 1),
        mirroring the cold start's lam0 = 1."""
        return (torch.zeros(self.nq, device=device),
                torch.ones(self.n_constraint_rows(), device=device))

    def canon_duals(self, lam: Tensor) -> Tensor:
        """Replace rows 2c/2c+1 of contact c by their mean (the canonical
        cone-pair split), over any leading batch dims."""
        shp = lam.shape
        lp = lam.reshape(shp[:-1] + (shp[-1] // 2, 2))
        return lp.mean(-1, keepdim=True).expand(lp.shape).reshape(shp)

    def step_ws(self, x: Tensor, u: Tensor, carry):
        """Warm-started step for serial rollouts: the PDIP starts from the
        previous knot's (dq, lam) and runs ``qp_iters_ws`` iterations.  Not
        differentiable; Jacobians and sampling go through ``step``."""
        P, b = self._hessian_and_bias(x, u)
        C, d = self._constraint_rows(x)
        if C is None:
            return x + self._free_step(P, b), carry
        dq, (dq_c, lam_c) = solve_qp_warm(P, b, C, d, carry, self.qp_iters_ws)
        if self.canon_warm_duals:
            lam_c = self.canon_duals(lam_c)
        return x + dq, (dq_c, lam_c)

    def _step_batch_kernel(self, x: Tensor, u: Tensor) -> Tensor:
        """Batched cold step (B,nq), (B,m) -> (B,nq) as one batched solve
        at ``qp_iters``: K2 on CUDA tensors, the plain PDIP on CPU ones."""
        from .cuda_qp import solve_qp_batched
        P, b = self._hessian_and_bias(x, u)
        C, d = self._constraint_rows(x)
        return x + solve_qp_batched(P, b, C, d, self.qp_iters)

    def system(self, batch_kernel: bool = False) -> System:
        """The model as the framework's ``System``, with the warm chain and,
        where ``rollout.supports_model`` and ``rollout.chain_gate`` admit
        the model, the whole-chain line-search rollout (K4 on CUDA).
        ``batch_kernel`` routes ``step_batch`` through one batched solve
        (K2 on CUDA); single steps and Jacobians keep the differentiable
        ``step``."""
        use_ws = self.qp_iters_ws > 0 and bool(self.pairs)
        ls_rollout_fn = None
        if use_ws:
            from . import cuda_rollout, rollout
            if rollout.supports_model(self) and rollout.chain_gate(self):
                def ls_rollout_fn(*args):
                    return cuda_rollout.linesearch_rollout_cuda(self, *args)

        return System(name=self.name, dim_x=self.nq, dim_u=self.dim_u,
                      h=self.h, step=self.step,
                      step_ws_fn=self.step_ws if use_ws else None,
                      ws_init_fn=self.ws_init if use_ws else None,
                      ls_rollout_fn=ls_rollout_fn,
                      step_batch_fn=(self._step_batch_kernel
                                     if batch_kernel and self.pairs
                                     else None))

    def _est_sweep_fn(self, qp_iters_samples: int):
        """Fused estimation sweep (``System.est_sweep_fn``): the nominal
        steps at full accuracy (``self.qp_iters``) and every sample step at
        ``qp_iters_samples``, each as one batched solve (K2 on CUDA).  With
        ``dx=None`` (zero_order_B) the samples share the nominal state, so
        the contact rows are assembled once per knot.  The samples solve
        cold: warm starts from the nominal lose accuracy there (see the JAX
        package)."""
        from .cuda_qp import solve_qp_batched

        def est_sweep(x_nom, u_nom, dx, du):
            T, S, m = du.shape
            nq = self.nq
            Pn, bn = self._hessian_and_bias(x_nom, u_nom)
            Cn, dn = self._constraint_rows(x_nom)
            f_nom = x_nom + solve_qp_batched(Pn, bn, Cn, dn, self.qp_iters)

            if dx is None:
                xp = x_nom[:, None].expand(T, S, nq)
                Cb = Cn[:, None].expand((T, S) + Cn.shape[1:])
                db = dn[:, None].expand((T, S) + dn.shape[1:])
            else:
                xp = x_nom[:, None] + dx
                Cb, db = self._constraint_rows(xp)
            up = u_nom[:, None] + du
            Pb, bb = self._hessian_and_bias(xp, up)

            def flat(a):
                return a.reshape((T * S,) + a.shape[2:])

            dq = solve_qp_batched(flat(Pb), flat(bb), flat(Cb), flat(db),
                                  qp_iters_samples)
            return f_nom, xp + dq.reshape(T, S, nq)

        return est_sweep

    def estimation_surrogate(self, qp_iters: int = 15) -> System:
        """Cheaper system for the Monte-Carlo estimation sweep: fewer QP
        iterations, the fused sweep hook, and the batched step through one
        batched solve (K2 on CUDA) for the unfused modes.  Pass as
        ``IrsMpcParams.estimation_system``."""
        cheap = dataclasses.replace(self, qp_iters=qp_iters)
        sys = cheap.system(batch_kernel=True)
        if not self.pairs:
            return sys
        return dataclasses.replace(sys,
                                   est_sweep_fn=self._est_sweep_fn(qp_iters))
