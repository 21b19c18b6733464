"""iRS-MPC solver: iterative randomized-smoothing LQR with projected
feedback.

One iteration is

    sample -> batched step (or the system's fused estimation sweep) ->
    least-squares fit (A, B, c) -> tracking problem -> Riccati backward
    pass, or boxed ADMM when there are bounds -> linear plan ->
    line-searched feedback rollout of the true dynamics, clipped to the
    input bounds -> 5-channel cost,

all on the device of the solver's tensors.  Each solve follows the device
rule of its module: hand-written CUDA kernels for CUDA tensors (K1 Riccati,
K2 batched contact QPs, K3 boxed ADMM, K4 the whole contact line search),
plain PyTorch for CPU tensors.  ``forward_mode="resolve"`` replaces the
line search by one masked full-horizon boxed solve per knot (K1 and K3
at every knot on CUDA).  ``parallel_riccati`` (or ``riccati_backend=
"assoc"``) solves the trajectory QP by the associative-scan Riccati pass
instead, as plain tensor ops on either device, and ``mesh`` shards the
estimation over a (sample, knot) grid of devices, possibly spanning the
ranks of a ``torch.distributed`` group (``parallel/sharded.py``).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.base import System
from ..ops import admm as admm_ops
from ..ops import lqr as lqr_ops
from ..ops.estimators import (SmoothingConfig, TvLinearization, decouple_AB,
                              estimate_tv_matrices_fnom)
from ..parallel.sharded import sharded_estimate_tv_matrices
from ..utils import timing

Tensor = torch.Tensor

# Bound magnitudes must stay below BOUND_BIG / 10 (the JAX package masks
# unconstrained stages with BOUND_BIG).
BOUND_BIG = 1e7

# The systems whose dynamics probe (``IrsMpc._probe``) passed, each with the
# devices it passed on.  The probe's answer depends on the system and the
# device alone, so a constructor probes a system once on each device.
# Weakly keyed by the system itself: the entry goes with the system.
PROBED = weakref.WeakKeyDictionary()


@dataclasses.dataclass
class IrsMpcParams:
    """Optimal-control problem and algorithm configuration; the fields of
    the JAX package's ``IrsMpcParams``.  Arrays may be numpy arrays or
    tensors.  Bounds are (2, dim) arrays [lb; ub]; ``None`` disables them."""
    Q: object = None
    Qd: object = None
    R: object = None
    x0: object = None
    xd_trj: object = None
    u_trj_init: object = None

    x_bounds_abs: Optional[object] = None
    u_bounds_abs: Optional[object] = None
    x_bounds_rel: Optional[object] = None
    u_bounds_rel: Optional[object] = None
    bounds_trust_region: bool = False

    # Δu-cost mode: indices of actuated DOFs in x.  None => plain u'Ru cost.
    indices_u_into_x: Optional[object] = None
    # Unactuated DOFs in x, for the Qu/Qa cost-channel split.
    unactuated_indices: Optional[object] = None

    gradient_mode: str = "zero_order"
    smoothing: SmoothingConfig = dataclasses.field(
        default_factory=SmoothingConfig)
    decouple_AB: bool = False
    # Cheaper surrogate dynamics for the Monte-Carlo estimation sweep only
    # (e.g. a contact model with fewer QP iterations); rollouts and costs
    # always use the true system.
    estimation_system: Optional[System] = None

    forward_mode: str = "feedback"
    # Line-search step sizes; alpha=0 (last) keeps the nominal trajectory,
    # so the accepted iterate never regresses.
    line_search_alphas: tuple = (1.0, 0.6, 0.3, 0.1, 0.03, 0.0)
    # The associative-scan Riccati pass (plain tensor ops, O(log T) deep)
    # for the trajectory QP, unbounded or boxed.
    parallel_riccati: bool = False
    # "auto": the CUDA kernel for CUDA tensors, the plain loop for CPU ones;
    # "assoc": the associative scan, as ``parallel_riccati`` (and also in
    # resolve mode).
    riccati_backend: str = "auto"
    admm_iters: int = 60                 # boxed-QP sweeps
    admm_rho: float = 1.0
    admm_over_relax: float = 1.0
    seed: int = 0
    # A ``parallel.sharded.Mesh``: the estimation runs sharded over it.
    mesh: Optional[object] = None
    # The reference costs the final state with Q, not Qd; keep True to
    # match its cost curves (initial pendulum cost 1856.1541).
    report_final_cost_with_Q: bool = True
    # Called after every iteration with (iteration, x_trj, u_trj) tensors.
    iteration_callback: Optional[Callable] = None


def _on(a, device, dtype=torch.float32) -> Tensor:
    """``a``, an array-like or a tensor, as a ``dtype`` tensor on
    ``device``."""
    if not isinstance(a, Tensor):
        a = np.asarray(a)
    return torch.as_tensor(a, dtype=dtype).to(device)


class StepResult(NamedTuple):
    """What one iteration returns, as tensors on the solver's device."""
    x: Tensor            # (T+1, n) accepted state trajectory
    u: Tensor            # (T, m) accepted inputs
    cvec: Tensor         # (6,) accepted cost: total, then the 5 channels
    best: Tensor         # () index of the accepted line-search lane
    lane_costs: Tensor   # (A, 6) cost vector of every lane


@dataclasses.dataclass
class IterationStats:
    """Decomposed cost channels {Qu, Qu_final, Qa, Qa_final, R}.  Without
    an actuated/unactuated split the Qa channels carry the state cost."""
    cost: float
    cost_Qu: float
    cost_Qu_final: float
    cost_Qa: float
    cost_Qa_final: float
    cost_R: float
    wall_time: float


class IrsMpc:
    """Construct with (system, params, device), then ``iterate(n) ->
    (x_trj, u_trj, cost)``; history in ``x_trj_lst``/``u_trj_lst``/
    ``cost_lst`` and best-so-far in ``*_best``.  Trajectories stay tensors
    on ``device``: the card by default, where the kernels run; "cpu" runs
    the plain PyTorch versions.  Without a CUDA device the default
    raises.  The constructor rolls out the initial guess through
    ``System.rollout``: one launch of the system's whole-chain kernel (K4)
    on the card where the system has one, the warm chain knot by knot
    elsewhere.  Before that it checks the dynamics by one step, the first
    time a system meets a device (``_probe``)."""

    def __init__(self, system: System, params: IrsMpcParams,
                 device="cuda"):
        # The solver's id, which every span of its plan carries.
        self.plan = timing.new_plan()
        with timing.span("plan_init", plan=self.plan):
            self._init(system, params, device)

    def _init(self, system, params, device):
        """The constructor's work, inside its ``plan_init`` span."""
        self.system = system
        self.params = params
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"IrsMpc: device {device!r} but no CUDA device is "
                f"available; pass device='cpu' for the plain PyTorch path")
        self._validate()

        p, dev = params, self.device
        self.Q, self.Qd, self.R = (_on(p.Q, dev), _on(p.Qd, dev),
                                   _on(p.R, dev))
        self.x0 = _on(p.x0, dev)
        self.xd_trj = _on(p.xd_trj, dev)
        self.u_trj = _on(p.u_trj_init, dev)
        self.T = int(self.u_trj.shape[0])
        self.idx_u = (None if p.indices_u_into_x is None
                      else _on(p.indices_u_into_x, dev, torch.long))
        # The QP state is augmented with a prev-input block w_t = u_{t-1}
        # when the Δu cost needs it or relative input bounds must be
        # enforced in plain-u mode.
        self._aug = self.idx_u is not None or p.u_bounds_rel is not None
        self._mask_u = torch.zeros(system.dim_x, device=dev)
        if p.unactuated_indices is not None:
            self._mask_u[_on(p.unactuated_indices, dev, torch.long)] = 1.0
        # The JAX package takes the assoc pass for the feedback iteration
        # under either option, and in resolve mode under the backend only.
        self._assoc = p.parallel_riccati or p.riccati_backend == "assoc"
        self._alphas = torch.tensor(p.line_search_alphas, dtype=torch.float32,
                                    device=dev)
        # Array stds go to the device once, so that no iteration copies them.
        sm = p.smoothing
        def std(v):
            return v if isinstance(v, (int, float)) else _on(v, dev)

        self.smoothing = dataclasses.replace(sm, std_x=std(sm.std_x),
                                             std_u=std(sm.std_u))

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(p.seed)
        self.x_trj = system.rollout(self.x0, self.u_trj)
        cost = self.eval_cost(self.x_trj, self.u_trj)[0]
        with timing.span("sync"):
            self.cost = float(cost)

        self.x_trj_lst = [self.x_trj]
        self.u_trj_lst = [self.u_trj]
        self.cost_lst = [self.cost]
        self.stats_lst: list[IterationStats] = []
        self.x_trj_best = self.x_trj
        self.u_trj_best = self.u_trj
        self.cost_best = self.cost
        self.iter = 1
        self.start_time = time.perf_counter()

    # ------------------------------------------------------------------
    def _validate(self):
        s, p = self.system, self.params
        if s.dim_x == 0 or s.dim_u == 0:
            raise RuntimeError("System has zero states or inputs.")
        if np.shape(p.Q) != (s.dim_x, s.dim_x):
            raise RuntimeError("Q must be dim_x x dim_x.")
        if np.shape(p.Qd) != (s.dim_x, s.dim_x):
            raise RuntimeError("Qd must be dim_x x dim_x.")
        if np.shape(p.R) != (s.dim_u, s.dim_u):
            raise RuntimeError("R must be dim_u x dim_u.")
        self._probe()
        for name in ("x_bounds_abs", "u_bounds_abs",
                     "x_bounds_rel", "u_bounds_rel"):
            b = getattr(p, name)
            if b is None:
                continue
            if isinstance(b, Tensor):
                b = b.detach().cpu().numpy()
            mags = np.abs(np.asarray(b, np.float64))
            mags = mags[np.isfinite(mags)]
            if mags.size and mags.max() > BOUND_BIG / 10:
                raise RuntimeError(
                    f"{name} magnitude {mags.max():.3g} exceeds the "
                    f"representable limit {BOUND_BIG / 10:.3g}; use "
                    f"np.inf (or None) for unconstrained entries.")
        if p.forward_mode not in ("feedback", "resolve"):
            raise ValueError(f"forward_mode {p.forward_mode!r} not in "
                             f"('feedback', 'resolve')")
        if p.riccati_backend not in lqr_ops.BACKENDS:
            raise ValueError(f"riccati_backend {p.riccati_backend!r} not in "
                             f"{lqr_ops.BACKENDS}")

    def _probe(self):
        """One ``step`` at x = 0, u = 0 on the solver's device, once for
        each system and device in the process (``PROBED``; ``cuda`` is the
        current card): its output is checked for shape and dropped, and it
        draws no random numbers.  A probe that runs is the span ``probe``;
        a constructor that finds the pair passed counts ``probe_reused``.
        Only a pass is recorded, so a system whose step fails raises at
        every constructor."""
        s, dev = self.system, self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev in PROBED.get(s, ()):
            timing.count("probe_reused")
            return
        with timing.span("probe"):
            try:
                out = s.step(torch.zeros(s.dim_x, device=self.device),
                             torch.zeros(s.dim_u, device=self.device))
                if tuple(out.shape) != (s.dim_x,):
                    raise ValueError(
                        f"step returned shape {tuple(out.shape)}")
            except Exception as e:
                raise RuntimeError(
                    "Could not evaluate dynamics. Have you implemented it?"
                ) from e
        PROBED.setdefault(s, set()).add(dev)

    # ------------------------------------------------------------------
    @timing.spanned("cost")
    def eval_cost(self, x_trj: Tensor, u_trj: Tensor):
        """Returns (total, cost_Qu, cost_Qu_final, cost_Qa, cost_Qa_final,
        cost_R), each of shape (...) for x (..., T+1, n), u (..., T, m).

        Running state cost uses Q; the final state uses Q under
        ``report_final_cost_with_Q`` else Qd.  In Δu mode the R cost is
        du'R du with du_0 = u_0 - x_0[idx]."""
        mask_u = self._mask_u
        ex = x_trj[..., :-1, :] - self.xd_trj[:-1]
        Qf = self.Q if self.params.report_final_cost_with_Q else self.Qd
        ef = x_trj[..., -1, :] - self.xd_trj[-1]

        def quad(e, M):
            return torch.einsum("...i,ij,...j->...", e, M, e)

        cx = quad(ex, self.Q).sum(-1)
        cxf = quad(ef, Qf)
        cost_Qu = quad(ex * mask_u, self.Q).sum(-1)
        cost_Quf = quad(ef * mask_u, Qf)
        cost_Qa = cx - cost_Qu
        cost_Qaf = cxf - cost_Quf

        if self.idx_u is None:
            cost_R = quad(u_trj, self.R).sum(-1)
        else:
            u_prev = torch.cat([x_trj[..., :1, self.idx_u],
                                u_trj[..., :-1, :]], dim=-2)
            cost_R = quad(u_trj - u_prev, self.R).sum(-1)
        total = cost_Qu + cost_Qa + cost_Quf + cost_Qaf + cost_R
        return total, cost_Qu, cost_Quf, cost_Qa, cost_Qaf, cost_R

    # ------------------------------------------------------------------
    def _build_problem(self, tv: TvLinearization, x_trj):
        args = (tv.A, tv.B, tv.c, self.Q, self.Qd, self.R, x_trj[0],
                self.xd_trj)
        if self.idx_u is not None:
            return lqr_ops.build_delta_u_problem(*args, self.idx_u)
        if self._aug:
            # Plain u'Ru cost, but rel input bounds need the prev-u block.
            return lqr_ops.build_prev_u_tracking_problem(*args)
        return lqr_ops.build_tracking_problem(*args)

    def _bound(self, name):
        b = getattr(self.params, name)
        if b is None or (isinstance(b, Tensor) and b.device == self.device
                         and b.dtype == torch.float32):
            return b
        # A copy from the host waits for the device's queue.
        with timing.span("sync"):
            return _on(b, self.device)

    def _has_bounds(self):
        p = self.params
        return any(b is not None for b in (p.x_bounds_abs, p.u_bounds_abs,
                                           p.x_bounds_rel, p.u_bounds_rel))

    def _u_bounds_for_rollout(self, x_trj):
        """Per-knot (lb, ub) input bounds for the projected-feedback
        rollout from the abs bounds, recentred on the nominal under
        ``bounds_trust_region``."""
        T, m = self.T, self.system.dim_u
        lb = torch.full((T, m), -torch.inf, device=self.device)
        ub = torch.full((T, m), torch.inf, device=self.device)
        b = self._bound("u_bounds_abs")
        if b is not None:
            if self.params.bounds_trust_region:
                centre = (x_trj[:-1, self.idx_u] if self.idx_u is not None
                          else torch.zeros((T, m), device=self.device))
                lb = torch.maximum(lb, centre + b[0])
                ub = torch.minimum(ub, centre + b[1])
            else:
                lb = torch.maximum(lb, b[0])
                ub = torch.minimum(ub, b[1])
        return lb, ub

    def _box_bounds(self, x_trj) -> admm_ops.BoxBounds:
        """Per-knot BoxBounds of the trajectory QP, recentred on the
        nominal trajectory under ``bounds_trust_region``."""
        p = self.params
        T, n, m = self.T, self.system.dim_x, self.system.dim_u

        def box(b, rows, dim):
            return torch.stack([b[0].expand(rows, dim), b[1].expand(rows, dim)])

        bx = self._bound("x_bounds_abs")
        if bx is not None:
            bx = (torch.stack([x_trj + bx[0], x_trj + bx[1]])
                  if p.bounds_trust_region else box(bx, T + 1, n))
        bu = self._bound("u_bounds_abs")
        if bu is not None:
            if p.bounds_trust_region and self.idx_u is not None:
                centre = x_trj[:-1, self.idx_u]
                bu = torch.stack([centre + bu[0], centre + bu[1]])
            else:
                bu = box(bu, T, m)
        bdx = self._bound("x_bounds_rel")
        bdu = self._bound("u_bounds_rel")
        if bdu is not None:
            bdu = box(bdu, T, m).clone()
            if self.idx_u is None:
                # Plain-u mode: no predecessor input at t=0 (the Δu mode
                # anchors to x0[idx_u]); the first stage is unconstrained.
                bdu[0, 0] = -BOUND_BIG
                bdu[1, 0] = BOUND_BIG
        return admm_ops.BoxBounds(
            x=bx, u=bu, dx=None if bdx is None else box(bdx, T, n), du=bdu)

    def _rel_bounds_for_rollout(self):
        """Per-knot (rel_lb, rel_ub) of u_t - u_{t-1}, or (None, None); in
        plain-u mode the t=0 row is unconstrained (as in ``_box_bounds``)."""
        rel = self._bound("u_bounds_rel")
        if rel is None:
            return None, None
        T, m = self.T, self.system.dim_u
        rel_lb = rel[0].expand(T, m).clone()
        rel_ub = rel[1].expand(T, m).clone()
        if self.idx_u is None:
            rel_lb[0] = -torch.inf
            rel_ub[0] = torch.inf
        return rel_lb, rel_ub

    def _iteration(self, x_trj, u_trj, it, perturbations=None) -> StepResult:
        """One smoothing + descent iteration, all on the device.
        ``perturbations`` is handed to the estimator (see
        ``estimate_tv_matrices_fnom``)."""
        p = self.params
        sys = self.system
        n, m = sys.dim_x, sys.dim_u
        # The cheaper estimation surrogate is justified by Monte-Carlo noise
        # in the sample targets; "exact" draws none, so it always
        # linearises the true system.
        est_sys = (sys if p.gradient_mode == "exact"
                   else p.estimation_system or sys)
        with timing.span("estimation"):
            if p.mesh is not None:
                tv = sharded_estimate_tv_matrices(
                    est_sys, p.gradient_mode, x_trj, u_trj, self.generator,
                    it, self.smoothing, p.mesh, perturbations)
                f_nom = None
            else:
                # need_A=False: decouple_AB is about to overwrite A.
                tv, f_nom = estimate_tv_matrices_fnom(
                    est_sys, p.gradient_mode, x_trj, u_trj, self.generator,
                    it, self.smoothing, perturbations,
                    need_A=not p.decouple_AB)
            if p.decouple_AB:
                tv = decouple_AB(tv, self.idx_u, x_trj, u_trj, sys,
                                 f_nom=f_nom)

        prob = self._build_problem(tv, x_trj)
        if p.forward_mode == "resolve":
            return self._resolve_iteration(prob, x_trj, u_trj)
        if self._has_bounds():
            idx_w = (torch.arange(n, n + m, device=self.device)
                     if self._aug else None)
            bounds = self._box_bounds(x_trj)
            with timing.span("lqr"):
                sol = admm_ops.solve_boxed_tvlqr(
                    prob, bounds, n_phys=n, idx_w=idx_w, rho=p.admm_rho,
                    iters=p.admm_iters, over_relax=p.admm_over_relax,
                    parallel=self._assoc)
            K, z_plan, u_plan = sol.gains.K, sol.x_trj, sol.u_trj
        else:
            with timing.span("lqr"):
                z_plan, u_plan, gains = lqr_ops.lqr_solve(
                    prob, parallel=self._assoc)
            K = gains.K
        # Sanitise: a degenerate estimate must not poison the alpha=0 lane,
        # which reproduces the nominal trajectory exactly.
        K = torch.nan_to_num(K)
        z_plan = torch.nan_to_num(z_plan)
        u_plan = torch.nan_to_num(u_plan)

        # Forward pass: roll the true dynamics under affine feedback around
        # the plan, u_t = u*_t - K_t (z_t - z*_t), clipped first to the rel
        # then to the abs input bounds, for every step size alpha at once
        # (one lane per alpha).  Alpha blends the plan toward the nominal;
        # alpha=0 reproduces the nominal.
        lb, ub = self._u_bounds_for_rollout(x_trj)
        rel_lb, rel_ub = self._rel_bounds_for_rollout()
        u_prev0 = (x_trj[0, self.idx_u] if self.idx_u is not None
                   else torch.zeros(m, device=self.device))
        if self._aug:
            w_nom = torch.cat([u_prev0[None], u_trj[:-1]], dim=0)
            z_nom = torch.cat([x_trj[:-1], w_nom], dim=1)
        else:
            z_nom = x_trj[:-1]
        a3 = self._alphas[:, None, None]
        z_ref = z_nom + a3 * (z_plan[:-1] - z_nom)         # (A, T, nz)
        u_ref = u_trj + a3 * (u_plan - u_trj)              # (A, T, m)

        with timing.span("rollout"):
            xs_all, us_all = self._rollout_lanes(
                x_trj[0], u_prev0, K, z_ref[..., :n],
                z_ref[..., n:] if self._aug else None, u_ref, lb, ub,
                rel_lb, rel_ub)
        costs_all = torch.stack(self.eval_cost(xs_all, us_all), dim=1)

        totals = torch.where(torch.isnan(costs_all[:, 0]), torch.inf,
                             costs_all[:, 0])
        best = torch.argmin(totals).reshape(1)
        return StepResult(x=xs_all.index_select(0, best)[0],
                          u=us_all.index_select(0, best)[0],
                          cvec=costs_all.index_select(0, best)[0],
                          best=best[0], lane_costs=costs_all)

    def _resolve_iteration(self, prob, x_trj, u_trj) -> StepResult:
        """The resolve forward pass: no line search; the nominal is kept
        only where the re-solved trajectory's cost is not finite."""
        x_new, u_new = self._resolve_forward(prob, x_trj)
        cvec = torch.stack(self.eval_cost(x_new, u_new))
        bad = ~torch.isfinite(cvec[0])
        x_new = torch.where(bad, x_trj, x_new)
        u_new = torch.where(bad, u_trj, u_new)
        cvec = torch.where(bad, torch.stack(self.eval_cost(x_trj, u_trj)),
                           cvec)
        return StepResult(x=x_new, u=u_new, cvec=cvec,
                          best=torch.zeros((), dtype=torch.long,
                                           device=self.device),
                          lane_costs=cvec[None])

    def _resolve_forward(self, prob, x_trj):
        """Receding-horizon forward pass: at every knot t, re-solve the
        boxed QP over [t, T] from the state actually reached and apply
        u*[t] to the true dynamics (T boxed solves, one after another).

        Each subproblem is the full-horizon problem with stages s < t
        padded: identity dynamics (in Δu mode the prev-input block pinned
        to x[idx_u]), zero cost but a 1e-4 input ridge, and boxes masked
        to +-BOUND_BIG; the final state keeps its box.  Its tail [t, T] is
        then the shrunk-horizon QP.  Returns x (T+1, n), u (T, m)."""
        p, sys = self.params, self.system
        T, n, m = self.T, sys.dim_x, sys.dim_u
        dev = self.device
        n_aug = prob.A.shape[1]
        # Padded stages: x' = x; w' = x[idx_u] in Δu mode, else w' = w (the
        # prev-input block carries the applied input through the padding,
        # so the tail's first relative bound anchors to it).
        A_pad = torch.eye(n_aug, device=dev)
        if self.idx_u is not None:
            A_pad[n:] = 0.0
            A_pad[torch.arange(n, n_aug, device=dev), self.idx_u] = 1.0
        R_pad = 1e-4 * torch.eye(m, device=dev)
        bounds = self._box_bounds(x_trj)
        idx_w = torch.arange(n, n_aug, device=dev) if self._aug else None
        steps = torch.arange(T + 1, device=dev)

        def masked(b, keep):
            if b is None:
                return None
            keep = keep[:, None]
            return torch.stack([torch.where(keep, b[0], -BOUND_BIG),
                                torch.where(keep, b[1], BOUND_BIG)])

        x = x_trj[0]
        u_prev = (x_trj[0, self.idx_u] if self.idx_u is not None
                  else torch.zeros(m, device=dev))
        ws = sys.ws_init_fn(dev) if sys.step_ws_fn is not None else None
        xs, us = [x], []
        for t in range(T):
            keep_x = steps >= t               # the final state always
            keep = keep_x[:T]
            mk = keep.to(prob.A.dtype)[:, None, None]
            if self.idx_u is not None:
                z0 = torch.cat([x, x[self.idx_u]])
            elif self._aug:
                z0 = torch.cat([x, u_prev])
            else:
                z0 = x
            prob_t = prob._replace(
                A=mk * prob.A + (1 - mk) * A_pad, B=mk * prob.B,
                c=mk[..., 0] * prob.c, Q=mk * prob.Q,
                R=mk * prob.R + (1 - mk) * R_pad, N=mk * prob.N,
                q=mk[..., 0] * prob.q, r=mk[..., 0] * prob.r, x0=z0)
            bounds_t = admm_ops.BoxBounds(
                x=masked(bounds.x, keep_x), u=masked(bounds.u, keep),
                dx=masked(bounds.dx, keep), du=masked(bounds.du, keep))
            sol = admm_ops.solve_boxed_tvlqr(
                prob_t, bounds_t, n_phys=n, idx_w=idx_w, rho=p.admm_rho,
                iters=p.admm_iters, over_relax=p.admm_over_relax,
                parallel=p.riccati_backend == "assoc")
            u = torch.nan_to_num(sol.u_trj[t])
            if ws is not None:
                x, ws = sys.step_ws_fn(x, u, ws)
            else:
                x = sys.step(x, u)
            xs.append(x)
            us.append(u)
            u_prev = u
        return torch.stack(xs), torch.stack(us)

    def _rollout_lanes(self, *args):
        """The line search's rollout, ``System.rollout_lanes`` (which picks
        K4 or the plain loop): the solver's own seam, where the benchmark's
        fault control plants altered states."""
        return self.system.rollout_lanes(*args)

    # ------------------------------------------------------------------
    def iterate(self, max_iterations: int, verbose: bool = True):
        """Run exactly ``max_iterations`` descent iterations.  The only host
        read per iteration is the accepted cost vector."""
        for _ in range(max_iterations):
            with timing.span("iteration", plan=self.plan) as rec:
                self._iterate_once(rec, verbose)
        return self.x_trj, self.u_trj, self.cost

    def _iterate_once(self, rec, verbose):
        """One pass of ``iterate``'s loop, in its span ``rec`` (None when
        the tracer is off): ``wall_time`` is host seconds on that span's
        clock, ``time.perf_counter``'s."""
        t0 = time.perf_counter_ns() if rec is None else rec.t0
        step = self._iteration(self.x_trj, self.u_trj, self.iter)
        x_new, u_new = step.x, step.u
        with timing.span("sync"):
            total, c_qu, c_quf, c_qa, c_qaf, c_r = step.cvec.tolist()
        wall = (time.perf_counter_ns() - t0) * 1e-9
        if verbose:
            print(f"Iteration: {self.iter:02d} || Current Cost: "
                  f"{total:.6f} || Elapsed time: "
                  f"{time.perf_counter() - self.start_time:.5f}")

        self.x_trj_lst.append(x_new)
        self.u_trj_lst.append(u_new)
        self.cost_lst.append(total)
        self.stats_lst.append(IterationStats(
            cost=total, cost_Qu=c_qu, cost_Qu_final=c_quf,
            cost_Qa=c_qa, cost_Qa_final=c_qaf, cost_R=c_r,
            wall_time=wall))

        if total < self.cost_best:
            self.cost_best = total
            self.x_trj_best = x_new
            self.u_trj_best = u_new

        if self.params.iteration_callback is not None:
            self.params.iteration_callback(self.iter, x_new, u_new)

        self.cost = total
        self.x_trj = x_new
        self.u_trj = u_new
        self.iter += 1
