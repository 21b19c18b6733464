"""Cross-entropy method baseline: a Gaussian population over whole input
trajectories, elite selection, mean and std refit.

The counterpart of the JAX package's ``solvers/cem.py``, with every knob:
Δu cost, input clipping, std floor, refit momentum, AR(1)-correlated noise,
persisted elites and band-limited (knot-interpolated) noise.

The population is scored by warm per-candidate chains, never by cold
batched steps (those corrupt elite selection on contact tasks, as the JAX
package measured): ``System.rollout``, which on float32 CUDA tensors rolls
every candidate in one call of a whole-chain rollout where the system has
one (kernel K4 for the contact models, open-loop lanes) and otherwise
steps all candidates together.  The refit mean and the initial trajectory
go through the same chain, so candidates and the accepted mean are scored
alike.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.base import System
from ..utils import timing

Tensor = torch.Tensor


@dataclasses.dataclass
class CemParams:
    """The fields of the JAX package's ``CemParams``; arrays may be numpy
    arrays or tensors."""
    Q: object = None
    Qd: object = None
    R: object = None
    x0: object = None
    xd_trj: object = None
    u_trj_init: object = None
    n_elite: int = 20
    batch_size: int = 200
    # (m,) per-input std, or a full (T, m) std to continue a search.
    initial_std: object = None
    # Δu-cost mode: indices of the actuated dofs in x.
    indices_u_into_x: Optional[object] = None
    # Clipping box (2, m) on the sampled inputs.
    u_bounds_abs: Optional[object] = None
    seed: int = 0
    # The reference costs the final state with Q, not Qd.
    report_final_cost_with_Q: bool = True
    # Elementwise floor on the refit std (scalar or (m,)).
    std_floor: Optional[object] = None
    # Refit smoothing a in [0, 1): new = (1 - a) refit + a previous, for
    # the mean and the std.
    momentum: float = 0.0
    # AR(1) correlation of the noise along the horizon, unit marginal
    # variance: eps_t = beta eps_{t-1} + sqrt(1 - beta^2) w_t.
    noise_beta: float = 0.0
    # The previous iteration's best elites re-enter the population.
    elite_keep: int = 0
    # Noise drawn at K knots over the horizon and linearly interpolated to
    # all T, rows renormalised to unit variance (0 = off).
    noise_knots: int = 0


class CemStep(NamedTuple):
    """One CEM iteration, as tensors on the solver's device."""
    x: Tensor            # (T+1, n) accepted state trajectory
    u: Tensor            # (T, m) accepted mean
    std: Tensor          # (T, m) refit std
    cost: Tensor         # () accepted cost
    kept: Optional[Tensor]   # (elite_keep, T, m) persisted elites
    cand: Tensor         # (B, T, m) the population
    costs: Tensor        # (B,) its costs, +inf where not finite
    elite_idx: Tensor    # (n_elite,) ascending in cost


def _on(a, device, dtype=torch.float32) -> Tensor:
    if not isinstance(a, Tensor):
        a = np.asarray(a)
    return torch.as_tensor(a, dtype=dtype).to(device)


def knot_weights(T: int, K: int) -> np.ndarray:
    """(T, K) linear-interpolation weights from K knots at
    linspace(0, T-1, K), rows rescaled to unit norm (unit marginal
    variance of the interpolated noise)."""
    t = np.arange(T, dtype=np.float64)
    pos = t * (K - 1) / (T - 1) if T > 1 else t * 0.0
    lo = np.minimum(np.floor(pos).astype(np.int64), K - 2)
    frac = pos - lo
    W = np.zeros((T, K))
    W[t.astype(np.int64), lo] = 1.0 - frac
    W[t.astype(np.int64), lo + 1] = frac
    return W / np.sqrt((W ** 2).sum(axis=1, keepdims=True))


class CrossEntropyMethod:
    """Construct with (system, params, device), then ``iterate(n) ->
    (x_trj, u_trj, cost)``; history in ``x_trj_lst``/``u_trj_lst``/
    ``cost_lst``, best-so-far in ``*_best``.  Runs on the card by default;
    "cpu" runs the plain PyTorch chains.  Without a CUDA device the
    default raises."""

    def __init__(self, system: System, params: CemParams, device="cuda"):
        # The solver's id, which every span of its plan carries.
        self.plan = timing.new_plan()
        with timing.span("plan_init", plan=self.plan):
            self._init(system, params, device)

    def _init(self, system, params, device):
        """The constructor's work, inside its ``plan_init`` span."""
        self.system = system
        self.params = params
        self.device = dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"CrossEntropyMethod: device {device!r} but no CUDA device "
                f"is available; pass device='cpu' for the plain path")
        p = params
        self.Q, self.Qd, self.R = _on(p.Q, dev), _on(p.Qd, dev), _on(p.R, dev)
        self.x0 = _on(p.x0, dev)
        self.xd_trj = _on(p.xd_trj, dev)
        self.u_trj = _on(p.u_trj_init, dev)
        self.T = T = int(self.u_trj.shape[0])
        m = system.dim_u
        self.idx_u = (None if p.indices_u_into_x is None
                      else _on(p.indices_u_into_x, dev, torch.long))
        init_std = _on(p.initial_std, dev)
        self.std_trj = (init_std if init_std.dim() == 2
                        else init_std.expand(T, m).clone())
        if tuple(self.std_trj.shape) != (T, m):
            raise ValueError(f"initial_std shape {tuple(init_std.shape)} "
                             f"incompatible with (T, m) = {(T, m)}")
        if not 0 <= p.momentum < 1:
            raise ValueError(f"momentum must be in [0, 1): {p.momentum}")
        if not 0 <= p.noise_beta < 1:
            raise ValueError(f"noise_beta must be in [0, 1): {p.noise_beta}")
        if not 0 <= p.elite_keep <= p.n_elite:
            raise ValueError("elite_keep must be in [0, n_elite]")
        if p.noise_knots < 0 or p.noise_knots > T:
            raise ValueError(f"noise_knots must be in [0, T]: "
                             f"{p.noise_knots}")
        if p.noise_knots == 1:
            raise ValueError("noise_knots must be 0 (off) or >= 2")
        self._knot_W = (_on(knot_weights(T, p.noise_knots), dev)
                        if p.noise_knots >= 2 else None)
        self._u_box = (None if p.u_bounds_abs is None
                       else _on(p.u_bounds_abs, dev))
        self._std_floor = (None if p.std_floor is None
                           else _on(p.std_floor, dev))
        # Persisted elites start as copies of the nominal, which puts the
        # nominal into the first population.
        self.kept = (self.u_trj[None].repeat(p.elite_keep, 1, 1)
                     if p.elite_keep > 0 else None)

        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(p.seed)
        self.x_trj = self.rollout(self.u_trj[None])[0]
        cost = self.eval_cost(self.x_trj, self.u_trj)
        with timing.span("sync"):
            self.cost = float(cost)

        self.x_trj_lst = [self.x_trj]
        self.u_trj_lst = [self.u_trj]
        self.cost_lst = [self.cost]
        self.cost_best = self.cost
        self.x_trj_best = self.x_trj
        self.u_trj_best = self.u_trj
        self.start_time = time.perf_counter()
        self.iter = 1

    # ------------------------------------------------------------------
    @timing.spanned("cost")
    def eval_cost(self, x_trj: Tensor, u_trj: Tensor) -> Tensor:
        """The trajectory cost, of shape (...) for x (..., T+1, n),
        u (..., T, m): running state cost with Q, the final state with Q
        under ``report_final_cost_with_Q`` else Qd, and u'Ru (Δu'RΔu with
        Δu_0 = u_0 - x_0[idx] in Δu mode)."""
        def quad(e, M):
            return torch.einsum("...i,ij,...j->...", e, M, e)

        ex = x_trj[..., :-1, :] - self.xd_trj[:-1]
        ef = x_trj[..., -1, :] - self.xd_trj[-1]
        Qf = self.Q if self.params.report_final_cost_with_Q else self.Qd
        c = quad(ex, self.Q).sum(-1) + quad(ef, Qf)
        if self.idx_u is None:
            return c + quad(u_trj, self.R).sum(-1)
        u_prev = torch.cat([x_trj[..., :1, self.idx_u], u_trj[..., :-1, :]],
                           dim=-2)
        return c + quad(u_trj - u_prev, self.R).sum(-1)

    def rollout(self, u_b: Tensor) -> Tensor:
        """(B, T, m) -> (B, T+1, n): every candidate's open-loop chain from
        x0, through ``System.rollout``."""
        with timing.span("rollout"):
            return self.system.rollout(self.x0, u_b)

    def _noise(self, noise: Optional[Tensor]) -> Tensor:
        """The population's unit noise (B, T, m) from a standard-normal
        draw (B, K, m) with ``noise_knots`` or (B, T, m) without, drawn
        from the generator unless ``noise`` gives it."""
        p = self.params
        B, m = p.batch_size, self.system.dim_u
        if noise is None:
            rows = p.noise_knots if self._knot_W is not None else self.T
            noise = torch.randn((B, rows, m), generator=self.generator,
                                device=self.device)
        if self._knot_W is not None:
            return torch.einsum("tk,bkm->btm", self._knot_W, noise)
        if p.noise_beta == 0:
            return noise
        # AR(1) low-pass along the horizon, unit marginal variance.
        beta = np.float32(p.noise_beta)
        scale = np.sqrt(np.float32(1.0) - beta * beta)
        e = noise[:, 0]
        out = [e]
        for t in range(1, self.T):
            e = beta * e + scale * noise[:, t]
            out.append(e)
        return torch.stack(out, dim=1)

    def _step(self, u_trj, std_trj, prev_x, prev_cost, kept,
              noise: Optional[Tensor] = None) -> CemStep:
        """One iteration from the mean ``u_trj`` and std ``std_trj``.
        ``noise`` supplies the raw standard-normal draw (see ``_noise``)
        instead of the generator."""
        p = self.params
        with timing.span("sample"):
            cand = u_trj[None] + std_trj[None] * self._noise(noise)
            if kept is not None:
                # The previous elites survive resampling verbatim (first
                # rows).
                cand = torch.cat([kept, cand[p.elite_keep:]], dim=0)
            if self._u_box is not None:
                cand = torch.minimum(torch.maximum(cand, self._u_box[0]),
                                     self._u_box[1])
        xs = self.rollout(cand)
        costs = self.eval_cost(xs, cand)
        # The refit: two spans, around the mean's rollout and cost.
        with timing.span("refit"):
            # Diverged rollouts (NaN/inf cost) never become elites.
            costs = torch.where(torch.isfinite(costs), costs, torch.inf)
            elite_idx = torch.topk(costs, p.n_elite, largest=False).indices
            elites = cand[elite_idx]
            u_new = elites.mean(0)
            std_new = elites.std(0, correction=0)
            if p.momentum > 0:
                a = np.float32(p.momentum)
                u_new = (1 - a) * u_new + a * u_trj
                std_new = (1 - a) * std_new + a * std_trj
            kept_new = elites[:p.elite_keep] if kept is not None else None
        x_new = self.rollout(u_new[None])[0]
        cost_new = self.eval_cost(x_new, u_new)
        with timing.span("refit"):
            # Divergence guard: the elites' mean can blow up on stiff
            # systems even when every elite was finite.  Fall back to the
            # best elite (its trajectory from the population's rollout) at
            # half the std; if the whole population diverged, keep the
            # previous mean, its trajectory, cost and std.
            best = elite_idx[0]
            # Each index by a device scalar reads it on the host.
            with timing.span("sync"):
                best_cost = costs[best]
            with timing.span("sync"):
                best_u = cand[best]
            with timing.span("sync"):
                best_x = xs[best]
            bad_mean = ~torch.isfinite(cost_new)
            use_elite = bad_mean & torch.isfinite(best_cost)
            use_prev = bad_mean & ~torch.isfinite(best_cost)
            w = torch.where
            u_new = w(use_prev, u_trj, w(use_elite, best_u, u_new))
            x_new = w(use_prev, prev_x, w(use_elite, best_x, x_new))
            cost_new = w(use_prev, prev_cost,
                         w(use_elite, best_cost, cost_new))
            std_new = w(use_prev, std_trj,
                        w(use_elite, 0.5 * std_trj, std_new))
            if self._std_floor is not None:
                std_new = torch.maximum(std_new, self._std_floor)
        return CemStep(x=x_new, u=u_new, std=std_new, cost=cost_new,
                       kept=kept_new, cand=cand, costs=costs,
                       elite_idx=elite_idx)

    # ------------------------------------------------------------------
    def iterate(self, max_iterations: int, verbose: bool = True):
        """Run exactly ``max_iterations`` iterations; the only host read
        per iteration is the accepted cost."""
        for _ in range(max_iterations):
            with timing.span("iteration", plan=self.plan):
                self._iterate_once(verbose)
        return self.x_trj, self.u_trj, self.cost

    def _iterate_once(self, verbose):
        """One pass of ``iterate``'s loop."""
        with timing.span("sync"):
            prev_cost = torch.tensor(self.cost, device=self.device)
        st = self._step(self.u_trj, self.std_trj, self.x_trj, prev_cost,
                        self.kept)
        with timing.span("sync"):
            cost = float(st.cost)
        if verbose:
            print(f"Iteration: {self.iter:02d} || Current Cost: "
                  f"{cost:.6f} || Elapsed time: "
                  f"{time.perf_counter() - self.start_time:.5f}")
        self.x_trj_lst.append(st.x)
        self.u_trj_lst.append(st.u)
        self.cost_lst.append(cost)
        if cost < self.cost_best:
            self.cost_best = cost
            self.x_trj_best = st.x
            self.u_trj_best = st.u
        self.x_trj, self.u_trj, self.std_trj = st.x, st.u, st.std
        self.kept = st.kept
        self.cost = cost
        self.iter += 1
