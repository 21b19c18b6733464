"""How ``correct`` is decided: a sample of the window's iterations, drawn
from the run's seed, each recomputed by the plain reference from the same
inputs and held to the cell's limits.

The program's iterations are recorded where they are produced
(``IrsMpc._iteration`` and ``CrossEntropyMethod._step``), with the nominal
each started from and, for iRS, the linearisation the program built
(``IrsMpc._build_problem``) and its nominal steps (the estimator's
``f_nom``).  A whole plan's curve is decided by float32 rounding and the
random stream, so the reference follows the program step by step from the
program's own nominal; each sampled plan's start (the constructor's
rollout of the initial guess) is checked by itself, and one sampled first
iteration of a plan is recomputed whole from the benchmark's inputs alone
(the reference's own start).  The random draws are worked out again from
the plan's solver seed: ``torch.randn`` calls on a generator of the
program's device, in the program's order, (dx, du) an iRS iteration and
one population an iteration of CEM.

Three samples are drawn: one over every iteration of the window, one over
the iterations whose zero-order fit float32 resolves (``resolved``), and
one of the plans' first iterations (iRS).  Where the input samples'
spread std_u * decay(it) falls below 2**-10 of the inputs' unit scale
(box pushing's 0.3 * 0.3**(it - 1) from its sixth iteration on), the fit
of B is float32 rounding of the sample steps' tiny differences in the
program as in its upstream, and a float64 reference draws a different
plan from the same inputs.  So the whole iteration is recomputed only
where the fit is resolved; in every sampled iteration the reference
checks the nominal steps (K2's nominal solves), the boxed LQR and the
line search on the program's own linearisation, and the accepted answer.

The numbers compared (each a worst case over the samples):
  init_cost_gap   |initial cost - reference| / reference (each sampled
                  iteration's plan's constructor)
  x_gap           max |accepted states - the reference's warm chain of the
                  accepted inputs from x0| (iRS: the accepted lane; CEM: the
                  refit mean), in state units
  cost_gap        |accepted cost - the reference's cost of that chain and
                  those inputs| / it
  lane_cost_gap   iRS, resolved and first iterations: max over step sizes
                  |lane cost - reference| / the reference's cost of the
                  nominal (its step size 0 lane), the reference running the
                  whole iteration (estimation, LQR, line search) from the
                  same nominal (a first iteration: its own start) and draws
  lqr_lane_cost_gap  iRS, every sampled iteration: the same gap, the
                  reference running the boxed LQR and the line search on
                  the program's linearisation (A, B, c) along its nominal
  fnom_gap        iRS, every sampled iteration: max |the program's nominal
                  steps - the reference's steps of the same nominal at the
                  full PDIP count|, in state units
  pop_cost_gap    CEM: max over candidates |cost - reference| / reference
  mean_cost_gap   CEM: |refit mean's cost - reference's refit| / reference
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import problem, traffic
from .reference.arith import Arith
from .reference.planner import Planner

LIMITS = Path(__file__).resolve().parent / "limits"


# An iteration's zero-order fit is resolved in float32 where its input
# samples spread at least this far (the inputs are O(1): positions in m).
RESOLUTION = 2.0 ** -10


class Record(NamedTuple):
    plan: int
    it: int
    inputs: tuple
    output: object
    seen: dict      # iRS: the program's linearisation "tv" and "f_nom"


def resolved(config: dict, mix: dict):
    """it -> whether iteration ``it``'s fit is resolved in float32."""
    if mix["solver"] == "cem" or mix["gradient_mode"] == "exact":
        return lambda it: True
    sm = config["smoothing"]
    return lambda it: sm["std_u"] * traffic.decay(sm["decay"], it) \
        >= RESOLUTION


class _Reservoir:
    def __init__(self, rng, k):
        self.rng, self.k, self.seen, self.items = rng, k, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class Recorder:
    """Keeps uniform samples of the window's iterations, reservoir-drawn
    from the run's seed: ``k`` over all, ``k`` over the resolved ones and,
    with ``first``, one of the plans' first iterations; and each plan's
    start."""

    def __init__(self, seed: int, k: int, is_resolved, first: bool):
        self.k, self.is_resolved, self.first_too = k, is_resolved, first
        self.active = False
        self.plan = None
        self.seen = None      # what the iteration under way has shown
        self.reset(seed)

    def reset(self, seed: int):
        """Empty samples drawn from ``seed``."""
        def reservoir(stream, k):
            return _Reservoir(
                np.random.default_rng([int(seed) % 2 ** 64, stream]), k)
        self.every = reservoir(1, self.k)
        self.resolved = reservoir(2, self.k)
        self.first = reservoir(3, 1)
        self.starts: dict = {}        # plan index -> (Plan, x0_trj, cost0)

    def offer(self, rec: Record):
        self.every.offer(rec)
        if self.is_resolved(rec.it):
            self.resolved.offer(rec)
        if self.first_too and rec.it == 1:
            self.first.offer(rec)

    def sample(self):
        """[(record, start)]: the reference recomputes the whole iteration
        from its own start of the plan (``"start"``) or from the
        program's nominal (``"nominal"``), or checks its parts on the
        program's own linearisation and its accepted answer (None)."""
        out = [(r, "start") for r in self.first.items]
        for kind, items in (("nominal", self.resolved.items),
                            (None, self.every.items)):
            out += [(r, kind) for r in items
                    if all(r is not q for q, _ in out)]
        return out

    def install(self, irs_cls, cem_cls, estimation):
        """Record every iteration of either solver while ``active``, with
        what an iRS iteration hands ``irs_cls._build_problem`` and gets
        from ``estimation.estimate_tv_matrices_fnom``."""
        rec = self
        irs_step, cem_step = irs_cls._iteration, cem_cls._step
        build, estimate = (irs_cls._build_problem,
                           estimation.estimate_tv_matrices_fnom)

        def _iteration(solver, x_trj, u_trj, it, perturbations=None):
            rec.seen = {} if rec.active else None
            out = irs_step(solver, x_trj, u_trj, it, perturbations)
            if rec.active:
                rec.offer(Record(rec.plan, int(it), (x_trj, u_trj), out,
                                 rec.seen))
            rec.seen = None
            return out

        def _build_problem(solver, tv, x_trj):
            if rec.seen is not None:
                rec.seen["tv"] = tv
            return build(solver, tv, x_trj)

        def estimate_tv_matrices_fnom(*args, **kwargs):
            out = estimate(*args, **kwargs)
            if rec.seen is not None:
                rec.seen["f_nom"] = out[1]
            return out

        def _step(solver, u_trj, std_trj, prev_x, prev_cost, kept,
                  noise=None):
            out = cem_step(solver, u_trj, std_trj, prev_x, prev_cost, kept,
                           noise)
            if rec.active:
                rec.offer(Record(rec.plan, int(solver.iter),
                                 (u_trj, std_trj, prev_x, prev_cost, kept),
                                 out, {}))
            return out

        irs_cls._iteration = _iteration
        irs_cls._build_problem = _build_problem
        estimation.estimate_tv_matrices_fnom = estimate_tv_matrices_fnom
        cem_cls._step = _step


def draw_shapes(config: dict, mix: dict):
    """The shapes of the random draws of one iteration, in order."""
    T, S, n, m = (config["T"], config["num_samples"], config["nq"],
                  config["m"])
    if mix["solver"] == "cem":
        return [(config["cem"]["batch_size"], T, m)]
    if mix["gradient_mode"] == "exact":
        return []
    return [(T, S, n), (T, S, m)]


def replay_draws(config, mix, seed: int, it: int, device):
    """The raw standard-normal draws of iteration ``it`` (1-based) of a
    solver seeded ``seed`` on ``device``, on the CPU."""
    shapes = draw_shapes(config, mix)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for _ in range(it - 1):
        for s in shapes:
            torch.randn(s, generator=g, device=device)
    return [torch.randn(s, generator=g, device=device).cpu()
            for s in shapes]


def reference_model(config: dict, ar):
    """The configuration's plain model, ``reference/<name>.py``."""
    mod = importlib.import_module(f"{__package__}.reference.{config['name']}")
    return mod.Model(config, ar)


def _rel(a, b, scale):
    """|a - b| / |scale| elementwise, 0 where both are not finite and inf
    where one is."""
    a, b = torch.as_tensor(a, dtype=torch.float64), \
        torch.as_tensor(b, dtype=torch.float64)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    gap = (a - b).abs() / torch.as_tensor(scale, dtype=torch.float64).abs()
    return torch.where(fa & fb, gap, torch.where(fa | fb, torch.inf, 0.0))


def _f64(t):
    return t.detach().to("cpu", torch.float64)


def observed(kind: str, rec: Record) -> dict:
    """What the program produced in a recorded iteration: the accepted
    states, inputs and cost, and the population's (CEM) or the lanes'
    (iRS) costs, with the nominal, the linearisation and the nominal
    steps (None where the program made none) of an iRS iteration."""
    out = rec.output
    if kind == "cem":
        return dict(x=_f64(out.x), u=_f64(out.u), cost=_f64(out.cost),
                    pop_costs=_f64(out.costs))
    tv, f_nom = rec.seen["tv"], rec.seen.get("f_nom")
    return dict(x=_f64(out.x), u=_f64(out.u), cost=_f64(out.cvec[0]),
                lane_costs=_f64(out.lane_costs[:, 0]),
                nominal=tuple(_f64(t) for t in rec.inputs),
                A=_f64(tv.A), B=_f64(tv.B), c=_f64(tv.c),
                f_nom=None if f_nom is None else _f64(f_nom))


def recomputed(kind, mode, planner, it: int, inputs, draws) -> dict:
    """The same outputs, recomputed by a reference planner from
    ``inputs`` (the iteration's, in the planner's arithmetic) and
    ``draws``."""
    if kind == "cem":
        out = planner.cem_step(*inputs, draws[0])
        return dict(x=out.x, u=out.u, cost=out.cost, pop_costs=out.costs)
    x, u = inputs
    lin, lanes = planner.irs_iteration(mode, x, u, it, draws)
    costs = torch.nan_to_num(lanes.costs[:, 0], nan=torch.inf)
    best = int(torch.argmin(costs))
    return dict(x=lanes.xs[best], u=lanes.us[best], cost=lanes.costs[best, 0],
                lane_costs=lanes.costs[:, 0], nominal=(x, u), A=lin.A,
                B=lin.B, c=lin.c, f_nom=lin.f_nom)


def accepted_gaps(planner, got: dict) -> dict:
    """x_gap and cost_gap of an accepted answer: its inputs rolled by the
    reference's warm chain from x0 and costed."""
    ar = planner.ar
    u = ar(got["u"])
    x = planner.model.rollout(planner.x0, u)
    cost = planner.cost(x, u)[0]
    return dict(x_gap=_rel(got["x"], x, 1.0).max().item(),
                cost_gap=_rel(got["cost"], cost, cost).item())


def descent_gaps(planner, got: dict) -> dict:
    """fnom_gap and lqr_lane_cost_gap of an iRS iteration: its nominal
    steps against the reference's of the same nominal, and its lanes
    against the reference's boxed LQR and line search on its own
    linearisation along that nominal."""
    ar = planner.ar
    x, u = (ar(t) for t in got["nominal"])
    lanes = planner.descend(x, u, ar(got["A"]), ar(got["B"]), ar(got["c"]))
    out = dict(lqr_lane_cost_gap=_rel(got["lane_costs"], lanes.costs[:, 0],
                                      lanes.costs[-1, 0]).max().item())
    if got["f_nom"] is not None:
        f_ref = planner.model.step(x[:-1], u, planner.model.qp_iters)
        out["fnom_gap"] = _rel(got["f_nom"], f_ref, 1.0).max().item()
    return out


def iteration_gaps(kind, got: dict, ref: dict) -> dict:
    """The numbers of a whole recomputed iteration."""
    if kind == "cem":
        return dict(
            pop_cost_gap=_rel(got["pop_costs"], ref["pop_costs"],
                              ref["pop_costs"]).max().item(),
            mean_cost_gap=_rel(got["cost"], ref["cost"], ref["cost"]).item())
    return dict(lane_cost_gap=_rel(got["lane_costs"], ref["lane_costs"],
                                   ref["lane_costs"][-1]).max().item())


def rows(config, mix, recorder: Recorder, device, control=False):
    """One row of numbers for each sampled iteration and each sampled
    plan's start: the program's against the float64 reference, or with
    ``control`` the reference computed in TF32 put in the program's
    place."""
    kind = mix["solver"]
    mode = mix.get("gradient_mode")
    ar = Arith(torch.float64)
    model = reference_model(config, ar)
    low = Arith(torch.float32, tf32=True) if control else None
    model_low = reference_model(config, low) if control else None
    sample = recorder.sample()
    out, starts = [], {}
    for plan_index in sorted({r.plan for r, _ in sample}):
        plan, _, cost0 = recorder.starts[plan_index]
        prob = problem.make(config, mix, plan)
        ref = Planner(model, config, prob).start(ar(prob.u_init))[1]
        starts[plan_index] = prob
        if control:
            cost0 = Planner(model_low, config, prob).start(
                low(prob.u_init))[1].item()
        out.append(dict(plan=plan_index, it=0,
                        init_cost_gap=_rel(cost0, ref, ref).item()))

    def inputs(planner, rec, start):
        """The iteration's inputs in ``planner``'s arithmetic: from the
        record, or for a first iteration the planner's own start."""
        if start == "start":
            u = planner.ar(starts[rec.plan].u_init)
            return planner.start(u)[0], u
        return tuple(None if t is None else planner.ar(_f64(t))
                     for t in rec.inputs)

    for rec, start in sample:
        prob = starts[rec.plan]
        planner = Planner(model, config, prob)
        draws = (replay_draws(config, mix, recorder.starts[rec.plan][0]
                              .solver_seed, rec.it, device)
                 if start or control else None)
        if control:
            lower = Planner(model_low, config, prob)
            got = recomputed(kind, mode, lower, rec.it,
                             inputs(lower, rec, start), draws)
            got = {k: tuple(map(_f64, v)) if k == "nominal" else _f64(v)
                   for k, v in got.items()}
        else:
            got = observed(kind, rec)
        row = dict(plan=rec.plan, it=rec.it, **accepted_gaps(planner, got))
        if kind != "cem":
            row.update(descent_gaps(planner, got))
        if start:
            row.update(iteration_gaps(kind, got, recomputed(
                kind, mode, planner, rec.it, inputs(planner, rec, start),
                draws)))
        out.append(row)
    return out


def worst(rows_) -> dict:
    """Each number's worst (largest) over rows."""
    out: dict = {}
    for row in rows_:
        for k, v in row.items():
            if k not in ("plan", "it"):
                out[k] = max(out.get(k, 0.0), v)
    return out


def numbers(config, mix, recorder: Recorder, device, control=False):
    """The cell's numbers: each one's worst over ``rows``."""
    return worst(rows(config, mix, recorder, device, control))


def load_limits(cell: str) -> dict:
    """The cell's limits, ``limits/<cell>.json``: {number: {"limit": ...,
    "lower": ..., "upper": ...}}."""
    return json.loads((LIMITS / f"{cell}.json").read_text())


def judge(values: dict, limits: dict):
    """(correct, {number: {"value", "limit"}}): every number within its
    limit, and every limit's number measured."""
    table, ok = {}, True
    for name, spec in limits.items():
        v = values.get(name)
        table[name] = {"value": v, "limit": spec["limit"]}
        ok = ok and v is not None and bool(np.isfinite(v)) \
            and v <= spec["limit"]
    return ok, table
