"""Dynamical-system abstraction of the PyTorch port.

A system is one step function ``x_{t+1} = step(x_t, u_t)`` written over
leading batch dimensions: ``step`` maps (..., n), (..., m) to (..., n), so
the batched step is the step itself.  Jacobians are derived with
``torch.func.jacfwd``, batched with ``torch.func.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..ops import _nvcc
from ..utils import timing

Tensor = torch.Tensor
StepFn = Callable[[Tensor, Tensor], Tensor]
# Sample projection onto a constraint manifold, batched over knots:
# (x (T,n), dx (T,S,n), u (T,m), du (T,S,m))
#     -> (x_proj (T,S,n), u_proj (T,S,m)).
ProjectionFn = Callable[[Tensor, Tensor, Tensor, Tensor],
                        tuple[Tensor, Tensor]]

# The constant arguments of ``System.rollout``'s kernel route (u_prev0 = 0,
# K = 0, a contiguous z_ref_x, lb = -inf, ub = inf), made once for each
# (lanes, T, m, n, device), so that no call copies them.
_CHAIN_ARGS: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class System:
    """A discrete-time dynamical system ``x_{t+1} = step(x_t, u_t)``."""

    name: str
    dim_x: int
    dim_u: int
    h: float
    step: StepFn
    projection: Optional[ProjectionFn] = None
    # Warm-started step for serial rollout chains, (x, u, carry) ->
    # (x_next, carry), over leading batch dims; ``ws_init_fn(device)``
    # builds the initial carry.  A system whose step is an iterative solve
    # (contact QPs) starts each knot from the previous knot's solution.
    # Must agree with ``step`` to solver tolerance; not differentiable, so
    # Jacobians always go through ``step``.
    step_ws_fn: Optional[Callable] = None
    ws_init_fn: Optional[Callable] = None
    # Fused Monte-Carlo estimation sweep of solver-backed systems:
    #   est_sweep_fn(x_nom (T,n), u_nom (T,m), dx (T,S,n) | None,
    #                du (T,S,m)) -> (f_nom (T,n), fd (T,S,n)),
    # the nominal steps at full solver accuracy and the sample steps in one
    # batched pass.  ``dx=None`` says the samples share the nominal state.
    est_sweep_fn: Optional[Callable] = None
    # Whole-chain line-searched feedback rollout,
    #   (x0, u_prev0, K, z_ref_x, z_ref_w | None, u_ref, lb, ub,
    #    rel_lb | None, rel_ub | None) -> (xs (A,T+1,n), us (A,T,m)),
    # which ``rollout_lanes`` and ``rollout`` take for float32 CUDA
    # tensors (kernel K4 for contact models).  Must match the plain loop
    # of ``rollout_lanes`` and, with zero gains and no bounds, the warm
    # chain.
    ls_rollout_fn: Optional[Callable] = None
    # Hand-written batched step, (B,n), (B,m) -> (B,n) (kernel K2 for the
    # contact models' estimation surrogate on CUDA); must agree with
    # ``step`` to solver tolerance.  Without one the batched step is
    # ``step`` itself.
    step_batch_fn: Optional[Callable] = None

    def step_batch(self, x: Tensor, u: Tensor) -> Tensor:
        """Batched dynamics: (B,n), (B,m) -> (B,n)."""
        if self.step_batch_fn is not None:
            return self.step_batch_fn(x, u)
        return self.step(x, u)

    def jacobian_xu(self, x: Tensor, u: Tensor) -> Tensor:
        """Fat Jacobian ``[df/dx | df/du]`` of shape (n, n+m).

        The step is evaluated on a batch of one: under ``jacfwd`` a 0-dim
        component times a Python float yields a float64 tangent, a 1-D one
        stays float32."""
        def step1(x1, u1):
            return self.step(x1[None], u1[None])[0]

        jx, ju = torch.func.jacfwd(step1, argnums=(0, 1))(x, u)
        return torch.cat([jx, ju], dim=1)

    def jacobian_xu_batch(self, x: Tensor, u: Tensor) -> Tensor:
        """Batched fat Jacobian: (B,n), (B,m) -> (B,n,n+m)."""
        return torch.func.vmap(self.jacobian_xu)(x, u)

    def _kernel_route(self, x0: Tensor, u: Tensor) -> bool:
        """Whether chains from ``x0`` under inputs ``u`` go through
        ``ls_rollout_fn``: the system has one and the tensors are float32
        on the card.  The one rule of ``rollout`` and ``rollout_lanes``."""
        return (self.ls_rollout_fn is not None and _nvcc.on_card(u)
                and x0.dtype == u.dtype == torch.float32)

    @timing.spanned("chain")
    def rollout(self, x0: Tensor, u_trj: Tensor) -> Tensor:
        """Open-loop rollout: (n,), (..., T, m) -> the (..., T+1, n) state
        trajectories.  Leading dims of ``u_trj`` are independent chains,
        each from ``x0``, all stepped together.  On the kernel route the
        chains are the open-loop lanes of one ``rollout_lanes`` call (one
        K4 launch: zero gains, no bounds, the inputs as the lanes' plan),
        counted ``chain_kernel``; every other call steps the warm chain
        (the plain one without ``step_ws_fn``) knot by knot.  Its span
        ``chain`` counts the ``knots`` it steps."""
        timing.count("knots", u_trj.shape[-2])
        if self._kernel_route(x0, u_trj):
            timing.count("chain_kernel")
            T, m = u_trj.shape[-2:]
            u_ref = u_trj.reshape(-1, T, m)
            A, n, dev = u_ref.shape[0], self.dim_x, u_ref.device
            key = (A, T, m, n, dev)
            if key not in _CHAIN_ARGS:
                # K = 0, so z_ref_x never reaches u: zeros serve every x0.
                inf = torch.full((T, m), torch.inf, device=dev)
                _CHAIN_ARGS[key] = (torch.zeros(m, device=dev),
                                    torch.zeros((T, m, n), device=dev),
                                    torch.zeros((A, T, n), device=dev),
                                    -inf, inf)
            u_prev0, K, z_ref_x, lb, ub = _CHAIN_ARGS[key]
            xs, _ = self.rollout_lanes(x0, u_prev0, K, z_ref_x, None, u_ref,
                                       lb, ub, None, None)
            return xs.reshape(u_trj.shape[:-2] + xs.shape[-2:])
        x = x0.expand(u_trj.shape[:-2] + x0.shape)
        xs = [x]
        if self.step_ws_fn is not None:
            ws = self.ws_init_fn(x0.device)
            for t in range(u_trj.shape[-2]):
                x, ws = self.step_ws_fn(x, u_trj[..., t, :], ws)
                xs.append(x)
        else:
            for t in range(u_trj.shape[-2]):
                x = self.step(x, u_trj[..., t, :])
                xs.append(x)
        return torch.stack(xs, dim=-2)

    def rollout_lanes(self, x0: Tensor, u_prev0: Tensor, K: Tensor,
                      z_ref_x: Tensor, z_ref_w: Optional[Tensor],
                      u_ref: Tensor, lb: Tensor, ub: Tensor,
                      rel_lb: Optional[Tensor], rel_ub: Optional[Tensor]):
        """The line-searched feedback rollout, ``ls_rollout_fn``'s
        arguments: every lane a of A from x0 under
        u_t = u_ref[a,t] - K_t (z_t - z_ref[a,t]), z = [x; u_prev] with
        ``z_ref_w`` (z_ref = [z_ref_x; z_ref_w]) else x, clipped first to
        u_prev + the rel bounds, then to [lb_t, ub_t].  Returns xs
        (A, T+1, n), us (A, T, m).  On the kernel route one
        ``ls_rollout_fn`` call; every other call is the plain loop below,
        all lanes as one batch through the warm chain (or batched
        step)."""
        if self._kernel_route(x0, u_ref):
            return self.ls_rollout_fn(x0, u_prev0, K, z_ref_x, z_ref_w,
                                      u_ref, lb, ub, rel_lb, rel_ub)
        aug = z_ref_w is not None
        z_ref = torch.cat([z_ref_x, z_ref_w], dim=-1) if aug else z_ref_x
        n_lanes, T = u_ref.shape[:2]
        x = x0.expand(n_lanes, -1)
        u_prev = u_prev0.expand(n_lanes, -1)
        ws = (self.ws_init_fn(x0.device) if self.step_ws_fn is not None
              else None)
        xs, us = [x], []
        for t in range(T):
            z = torch.cat([x, u_prev], dim=1) if aug else x
            u = u_ref[:, t] - (z - z_ref[:, t]) @ K[t].T
            if rel_lb is not None:
                u = torch.minimum(torch.maximum(u, u_prev + rel_lb[t]),
                                  u_prev + rel_ub[t])
            u = torch.minimum(torch.maximum(u, lb[t]), ub[t])
            if ws is not None:
                x, ws = self.step_ws_fn(x, u, ws)
            else:
                x = self.step_batch(x, u)
            xs.append(x)
            us.append(u)
            u_prev = u
        return torch.stack(xs, dim=1), torch.stack(us, dim=1)
