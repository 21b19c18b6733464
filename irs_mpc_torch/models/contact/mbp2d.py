"""Second-order planar rigid-body dynamics with contact.

The counterpart of the JAX package's ``models/contact/mbp2d.py``: x = (q, v)
over the geometry, bodies and contact rows of a ``QuasistaticModel``, and
one Anitescu velocity-level step a knot, the same convex QP layer as the
quasistatic engine, now over the next velocity:

    v_free = (v + h tau(q, u) / M) / (1 + h visc / M)
    min_v'  1/2 (v' - v_free)' M (v' - v_free)
    s.t.    (J_n +- mu J_t)(h v') + phi >= 0
    q_next = q + h v',   x_next = (q_next, v')

``tau`` holds the spring (position mode, kp (u - q)), torque (torque mode)
and gravity terms; every viscous term is implicit.  Every method works over
leading batch dims.  The system has the warm chain only: no fused sweep, no
whole-chain rollout and no batched-step kernel, as in the JAX package
(see ``estimation_surrogate``), so its paths launch K1 and K3 alone.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..base import System
from .qp import solve_qp, solve_qp_warm
from .quasistatic import QuasistaticModel

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Mbp2DModel:
    """Second-order wrapper around a ``QuasistaticModel``'s geometry.

    ``base`` supplies bodies, pairs, model instances and gravity.  The
    actuated dofs' masses come from ``actuated_mass`` (the quasistatic
    model treats them as massless position servos); ``damping`` is a
    diagonal joint-space viscous term, and in position mode each actuated
    dof adds kd = ``kd_ratio`` kp."""
    base: QuasistaticModel
    actuated_mass: Tuple[float, ...]
    damping: float = 0.2
    control_mode: str = "position"     # "position" (PD) | "torque"
    kd_ratio: float = 0.2

    @property
    def nq(self) -> int:
        return self.base.nq

    @property
    def dim_x(self) -> int:
        return 2 * self.base.nq

    @property
    def dim_u(self) -> int:
        # Desired positions or torques on the same actuated dofs.
        return self.base.dim_u

    def _mass_vector(self) -> np.ndarray:
        """(nq,) float32 masses."""
        m = np.zeros(self.nq, np.float32)
        ia = 0
        for inst in self.base.models:
            idx = list(inst.q_indices)
            if inst.actuated:
                m[idx] = np.asarray(self.actuated_mass[ia:ia + len(idx)],
                                    np.float32)
                ia += len(idx)
            else:
                m[idx] = np.asarray(inst.mass, np.float32)
        return m

    def _viscosity(self) -> np.ndarray:
        """(nq,) float32 viscous coefficients: ``damping``, plus kd =
        ``kd_ratio`` kp on the actuated dofs in position mode."""
        visc = np.full(self.nq, self.damping, np.float32)
        if self.control_mode == "position":
            for inst in self.base.models:
                if inst.actuated:
                    visc[list(inst.q_indices)] += (
                        np.float32(self.kd_ratio)
                        * np.asarray(inst.stiffness, np.float32))
        return visc

    def _constants(self, device, dtype):
        """(M, visc, diag(M)) on ``device``, made once for each device and
        dtype: a copy from the host would wait on the device's queue at
        every step."""
        cache = self.__dict__.setdefault("_device_constants", {})
        if (device, dtype) not in cache:
            M = torch.from_numpy(self._mass_vector()).to(device, dtype)
            visc = torch.from_numpy(self._viscosity()).to(device, dtype)
            cache[device, dtype] = (M, visc, torch.diag(M))
        return cache[device, dtype]

    def _free_velocity(self, q: Tensor, v: Tensor, u: Tensor,
                       M: Tensor) -> Tensor:
        """The contact-free next velocity, semi-implicit with every viscous
        term implicit (explicit damping diverges once (kd + damping) h / m
        > 2, which stiff PD gains reach)."""
        nq = self.nq
        zero = torch.zeros_like(q[..., 0])
        tau = [zero] * nq
        g = np.asarray(self.base.gravity, np.float32)
        iu = 0
        for inst in self.base.models:
            idx = list(inst.q_indices)
            if inst.actuated:
                if self.control_mode == "position":
                    kp = np.asarray(inst.stiffness, np.float32)
                    for j, qi in enumerate(idx):
                        tau[qi] = tau[qi] + float(kp[j]) * (
                            u[..., iu + j] - q[..., qi])
                else:
                    for j, qi in enumerate(idx):
                        tau[qi] = tau[qi] + u[..., iu + j]
                iu += len(idx)
            elif len(idx) >= 2:
                # Gravity on the translation dofs (the first two) of an
                # unactuated body.
                mass = np.asarray(inst.mass, np.float32)
                for j in range(2):
                    tau[idx[j]] = tau[idx[j]] + float(mass[j] * g[j])
        tau = torch.stack(tau, dim=-1)
        _, visc, _ = self._constants(q.device, q.dtype)
        h = self.base.h
        return (v + h * tau / M) / (1.0 + h * visc / M)

    def _contact_qp(self, q: Tensor, v_free: Tensor):
        """(P, b, C, d) of the velocity-level contact QP
        min 1/2 v'Mv - (M v_free)'v  s.t.  -(h G) v <= phi, or Nones
        without contact pairs."""
        G, phi = self.base.contact_rows(q)
        if G is None:
            return None, None, None, None
        M, _, P = self._constants(q.device, q.dtype)
        return (P.expand(q.shape[:-1] + P.shape), -(M * v_free),
                -self.base.h * G, phi)

    def _split(self, x: Tensor, u: Tensor):
        q, v = x[..., :self.nq], x[..., self.nq:]
        M, _, _ = self._constants(x.device, x.dtype)
        v_free = self._free_velocity(q, v, u, M)
        return q, v_free, self._contact_qp(q, v_free)

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        """One step over leading batch dims; differentiable in forward mode
        through the QP's implicit-function JVP (``torch.func.jacfwd``)."""
        q, v_free, (P, b, C, d) = self._split(x, u)
        v_next = (v_free if P is None
                  else solve_qp(P, b, C, d, self.base.qp_iters))
        return torch.cat([q + self.base.h * v_next, v_next], dim=-1)

    def ws_init(self, device="cpu"):
        """Initial warm carry of a rollout chain: (v', lam) = (0, 1)."""
        return (torch.zeros(self.nq, device=device),
                torch.ones(self.base.n_constraint_rows(), device=device))

    def step_ws(self, x: Tensor, u: Tensor, carry):
        """Warm-started step for serial rollouts: the PDIP starts from the
        previous knot's (v', lam) and runs ``base.qp_iters_ws``
        iterations.  Not differentiable."""
        q, v_free, (P, b, C, d) = self._split(x, u)
        if P is None:
            v_next = v_free
        else:
            v_next, carry = solve_qp_warm(P, b, C, d, carry,
                                          self.base.qp_iters_ws)
        return torch.cat([q + self.base.h * v_next, v_next], dim=-1), carry

    def system(self) -> System:
        """The model as a ``System`` with its warm chain (when it has
        contact pairs and warm iterations)."""
        use_ws = self.base.qp_iters_ws > 0 and bool(self.base.pairs)
        return System(name=f"{self.base.name}_mbp",
                      dim_x=self.dim_x, dim_u=self.dim_u,
                      h=self.base.h, step=self.step,
                      step_ws_fn=self.step_ws if use_ws else None,
                      ws_init_fn=self.ws_init if use_ws else None)

    def indices_u_into_x(self) -> np.ndarray:
        """The actuated POSITION indices into the (q, v) state, for the
        Δu-cost position-controlled solver."""
        return self.base.indices_u_into_x()

    def estimation_surrogate(self, qp_iters: int = 20) -> System:
        """A cheaper system for the Monte-Carlo estimation sweep (pass as
        ``IrsMpcParams.estimation_system``): the velocity QP at a reduced
        iteration budget for sample steps and sample Jacobians.  The JAX
        package measured the second-order planar-hand curves to be
        basin-chaotic under any such perturbation of the estimate, so its
        example drivers, and the configurations of ``chip_smoke.py``, do
        not use it."""
        cheap = dataclasses.replace(
            self, base=dataclasses.replace(self.base, qp_iters=qp_iters))
        return cheap.system()

