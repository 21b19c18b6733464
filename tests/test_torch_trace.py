"""The port's tracer (``irs_mpc_torch.utils.timing``) on the CPU: off it
records nothing; on it nests spans under their parents, gives a plan's
spans its solver's id and counts on the innermost span; a profiler
session switches it on and its exported trace holds the ``irs/<name>``
ranges; one iteration of each solver records the spans of its phases in
order; and nothing it records changes a trajectory or a cost.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_torch import CrossEntropyMethod  # noqa: E402
from irs_mpc_torch.examples import box_pushing, box_pushing_cem  # noqa: E402
from irs_mpc_torch.utils import timing  # noqa: E402

# One iteration of each solver on the CPU, the spans in the order they
# open.  iRS (box pushing, relative input bounds, decouple_AB, 30 ADMM
# sweeps): the estimation (decouple_AB's index write copies its value
# from the host), the QP's bounds from the host, the boxed LQR, whose
# plain loop writes its du selector (a copy from the host) twice for its
# first penalised problem and once a sweep (K3 on the card writes it
# once), the rollout's bounds from the host, the line search's lanes and
# their cost, then the cost vector's read.  CEM: the previous cost to the
# device, the population's noise, its rollout (the plain warm chain on the
# CPU) and cost, the refit, the mean's rollout and cost, the divergence
# guard (three reads of device scalars), then the accepted cost's read.
IRS_ITERATION = (["iteration", "estimation", "sync", "sync", "lqr"]
                 + ["sync"] * 32 + ["sync", "rollout", "cost", "sync"])
CEM_ITERATION = ["iteration", "sync", "sample", "rollout", "chain", "cost",
                 "refit", "rollout", "chain", "cost", "refit", "sync",
                 "sync", "sync", "sync"]


def _irs():
    solver, _ = box_pushing.build_solver(num_samples=8, T=6, device="cpu")
    return solver


def _cem():
    """Box pushing's CEM with every knob of the refit and the sampling
    on: AR(1) noise, kept elites, momentum and a std floor."""
    solver, _ = box_pushing_cem.build_solver(T=6, batch_size=12, n_elite=4,
                                             device="cpu")
    params = dataclasses.replace(solver.params, noise_beta=0.85,
                                 elite_keep=2, momentum=0.1,
                                 std_floor=np.float32(0.01))
    return CrossEntropyMethod(solver.system, params, device="cpu")


@pytest.fixture(autouse=True)
def _empty_tracer():
    timing.reset()
    yield
    timing.reset()


def test_off_a_run_records_nothing():
    assert not timing.TRACER.enabled and not timing.profiling()
    _irs().iterate(1, verbose=False)
    _cem().iterate(1, verbose=False)
    assert timing.records() == [] and timing.report() == ""


def test_spans_nest_share_a_plan_and_count_on_the_innermost():
    with timing.tracing():
        with timing.span("outer", plan=7) as outer:
            timing.count("n", 2)
            with timing.span("inner") as inner:
                timing.count("n")
                timing.count("n", 3)
                timing.count("m")
            with timing.span("second"):
                pass
        with timing.span("loose") as loose:
            pass
        a, b = _irs(), _irs()
        a.iterate(1, verbose=False)
        b.iterate(1, verbose=False)
    recs = timing.records()
    assert [r.name for r in recs[:4]] == ["outer", "inner", "second",
                                          "loose"]
    assert (outer.parent, inner.parent, recs[2].parent) == (-1, 0, 0)
    assert (outer.plan, inner.plan, loose.plan) == (7, 7, -1)
    assert outer.counts == {"n": 2} and inner.counts == {"n": 4, "m": 1}
    assert recs[2].counts is None
    assert all(r.t0 <= r.t1 for r in recs)
    assert outer.t0 <= inner.t0 <= inner.t1 <= recs[2].t0 <= outer.t1
    # Each solver's spans carry its id, the constructor's and the
    # iteration's alike, and the two ids differ.
    by_plan = {}
    for r in recs[4:]:
        by_plan.setdefault(r.plan, []).append(r.name)
    assert sorted(by_plan) == sorted({a.plan, b.plan}) and a.plan != b.plan
    for names in by_plan.values():
        assert names[0] == "plan_init" and "iteration" in names
    # The constructor's rollout is the plain warm chain: T knots.
    chain = [r for r in recs if r.name == "chain"]
    assert [r.counts for r in chain] == [{"knots": 6}, {"knots": 6}]
    for r in recs[4:]:
        if r.parent >= 0:
            parent = recs[r.parent]
            assert parent.t0 <= r.t0 <= r.t1 <= parent.t1


def test_counted_sums_the_counts_of_a_name():
    with timing.tracing():
        with timing.span("estimation"):
            timing.count("est_graph")
            timing.count("est_capture")
        with timing.span("estimation"):
            timing.count("est_graph")
        with timing.span("estimation"):
            pass
        with timing.span("chain"):
            timing.count("knots", 6)
    assert timing.counted("estimation") == {"est_graph": 2, "est_capture": 1}
    assert timing.counted("chain") == {"knots": 6}
    assert timing.counted("lqr") == {}


def test_a_full_buffer_drops_spans_and_keeps_the_rest():
    tr = timing.Tracer(capacity=2)
    tr.enabled = True
    for name in "abc":
        with tr.span(name) as rec:
            tr.count("k")
        assert (rec is None) == (name == "c")
    assert [r.name for r in tr.records()] == ["a", "b"]
    assert tr.dropped == 1 and tr.records()[0].counts == {"k": 1}
    tr.reset()
    assert tr.records() == [] and tr.dropped == 0


def test_a_profiler_session_switches_the_tracer_on(tmp_path):
    solver = _irs()
    timing.reset()
    with timing.profile_trace(tmp_path):
        assert timing.profiling() and not timing.TRACER.enabled
        solver.iterate(1, verbose=False)
    assert not timing.profiling()
    names = [r.name for r in timing.records()]
    assert names == IRS_ITERATION
    trace = json.loads((tmp_path / "trace.json").read_text())
    ranges = [ev["name"] for ev in trace["traceEvents"]
              if ev.get("name", "").startswith("irs/")]
    assert sorted(ranges) == sorted(f"irs/{n}" for n in IRS_ITERATION)
    # After the session the tracer is off again.
    solver.iterate(1, verbose=False)
    assert len(timing.records()) == len(IRS_ITERATION)


@pytest.mark.parametrize("make, names", [(_irs, IRS_ITERATION),
                                         (_cem, CEM_ITERATION)],
                         ids=["irs", "cem"])
def test_one_iteration_records_its_phases_in_order(make, names):
    solver = make()
    with timing.tracing():
        solver.iterate(1, verbose=False)
    recs = timing.records()
    assert [r.name for r in recs] == names
    assert {r.plan for r in recs} == {solver.plan}
    assert recs[0].parent == -1
    assert all(r.parent >= 0 for r in recs[1:])


def test_wall_time_is_the_iteration_span_s_clock():
    solver = _irs()
    with timing.tracing():
        solver.iterate(1, verbose=False)
    it = timing.records()[0]
    wall = solver.stats_lst[-1].wall_time
    assert it.name == "iteration"
    assert 0.0 < wall <= (it.t1 - it.t0) * 1e-9
    solver.iterate(1, verbose=False)             # off: perf_counter
    assert solver.stats_lst[-1].wall_time > 0.0


@pytest.mark.parametrize("make", [_irs, _cem], ids=["irs", "cem"])
def test_tracing_changes_no_trajectory_or_cost(make):
    def run(on):
        with timing.tracing(on):
            solver = make()
            solver.iterate(2, verbose=False)
        return solver

    off, on = run(False), run(True)
    assert len(timing.records()) > 0
    assert off.cost_lst == on.cost_lst
    for a, b in zip(off.x_trj_lst + off.u_trj_lst,
                    on.x_trj_lst + on.u_trj_lst):
        assert torch.equal(a, b)
