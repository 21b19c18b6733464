"""The program's own spans as the benchmark reads them
(``benchmark/program_trace.py``): the clocks' offset fitted from the
calls the benchmark also ranges, the readers' arithmetic on a made-up
trace, nothing read from a program without the tracer; on a traced run
every span of such a call lies on its ``bench/`` range within 20 us at
both ends (on the CPU at a small size, on the card at the cells' own);
and on the card, every call of an iteration that synchronises is one of
the program's ``sync`` spans."""
import sys
import traceback
import types
import warnings

import pytest
import torch

from benchmark import harness, problem, program_trace, tracing, traffic
from benchmark.program import Program
from irs_mpc_torch.utils import timing

SEED = 2 ** 31 + 1414
CELLS = ("box_pushing.zero_order_B", "planar_hand.zero_order_B",
         "planar_hand.cem")
# The calls both the program and the benchmark span, and how near the
# mapped span lies to the benchmark's range at each end.
RANGED = ("plan_init", "estimation", "lqr", "rollout", "cost")
NEAR_S = 20e-6


@pytest.fixture(autouse=True)
def _empty_tracer():
    timing.reset()
    yield
    timing.reset()


def _rec(name, t0, t1, parent=-1, plan=0, counts=None):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, parent=parent,
                                 plan=plan, counts=counts)


def _run(recs, device, ranges, iterations, monkeypatch):
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    window = tracing.Interval("marked", 0.0, 1.0)
    block = tracing.Block(window, device, ranges, iterations)
    return harness.TraceRun({}, {}, [], block, None, 0)


def test_the_readers_on_a_made_up_trace(monkeypatch):
    """Records 5 s behind the trace's clock: the offset is found from the
    paired calls, and each reader counts what lies in its spans."""
    ns, off = 1e9, 5.0

    def at(t):                   # a trace time as the record's ns
        return int((t - off) * ns)

    recs = [_rec("plan_init", at(0.10), at(0.30)),
            _rec("chain", at(0.11), at(0.20), 0, counts={"knots": 4}),
            _rec("cost", at(0.21), at(0.22), 0),
            _rec("iteration", at(0.40), at(0.60)),
            _rec("estimation", at(0.41), at(0.45), 3),
            _rec("lqr", at(0.46), at(0.48), 3),
            _rec("sync", at(0.55), at(0.56), 3),
            _rec("sync", at(0.25), at(0.26), 0)]
    ranges = [tracing.Interval("bench/plan_init", 0.09, 0.30),
              tracing.Interval("bench/cost", 0.21, 0.22),
              tracing.Interval("bench/lqr", 0.46, 0.48)]
    k = lambda s, e, launched=None: tracing.Interval(  # noqa: E731
        "kernel_k", s, e, launched)
    device = [k(0.115, 0.116, 0.112), k(0.12, 0.13, 0.119),
              k(0.25, 0.26, 0.195),             # launched in the chain
              k(0.42, 0.43, 0.415), k(0.44, 0.47, 0.43),
              tracing.Interval("Memcpy HtoD", 0.15, 0.16, 0.15)]
    run = _run(recs, device, ranges, 2, monkeypatch)
    assert program_trace.offset(recs, ranges) == pytest.approx(off)
    m = program_trace.marked(run)
    assert [s.top for s in m.spans] == [None, "plan_init", "plan_init",
                                        None, "iteration", "iteration",
                                        "iteration", "plan_init"]
    # Three kernels (not the copy) launched in 4 knots of the chain.
    assert program_trace.kernels_per_count(run, "chain", "knots") == 0.75
    # Estimation 0.41-0.45: busy 0.42-0.43 and 0.44-0.45; 20 ms idle over
    # two iterations.
    assert program_trace.idle_ms_per_iteration(run, "estimation") == \
        pytest.approx(10.0)
    # The iteration's sync only (the constructor's is not an
    # iteration's).
    assert program_trace.host_ms_per_iteration(run, "sync") == \
        pytest.approx(5.0)
    assert program_trace.idle_ms_per_iteration(run, "refit") is None
    # 1 s of window, 0.071 s busy.  Idle in the phases: the chain 0.069
    # (0.021 busy), the cost 0.01, the estimation 0.02, the LQR 0.01, the
    # iteration's sync 0.01 (the constructor's ran under a kernel).  The
    # constructor: 0.169 idle, 0.079 of it in its phases.
    cov = program_trace.coverage(run)
    assert cov["idle_s"] == pytest.approx(0.929)
    assert cov["in_phases_s"] == pytest.approx(0.119)
    assert cov["plan_init_self_idle_s"] == pytest.approx(0.09)
    assert cov["iteration_self_idle_s"] == pytest.approx(0.2 - 0.04 - 0.04)


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """A timing module with no tracer, as the program had before it: every
    reader of its spans reports nothing, and raises nothing."""
    monkeypatch.setitem(sys.modules, "irs_mpc_torch.utils.timing",
                        types.SimpleNamespace(profile_trace=None))
    assert program_trace.records() is None
    window = tracing.Interval("marked", 0.0, 1.0)
    run = harness.TraceRun({}, {}, [], tracing.Block(window, [], [], 1),
                           None, 0)
    for name in ("driver.chain_kernels_per_knot", "estimation.idle_ms",
                 "driver.host_wait_ms", "driver.host_wait_ms.cem",
                 "cem.sample_idle_ms", "cem.refit_idle_ms"):
        assert harness.metric_reader(name).read(run) is None


def _traced_plan(c, device, monkeypatch):
    """One plan under the profiler, its layers marked: the run the
    readers get."""
    monkeypatch.setattr(harness, "PROFILED_MARKED", 1)
    monkeypatch.setattr(harness, "PROFILED_SYNCED", 0)
    s = harness.set_up(c, SEED, device, True)
    timing.reset()
    w = harness.run_window(c, s, SEED, 1e-3, True)
    assert w.plans == 1
    marked, synced = w.profile
    return harness.TraceRun(c.config, c.mix, s.spans.records, marked, synced,
                            0)


def _spans_lie_on_their_ranges(run):
    """Each mapped span of a call the benchmark ranges against that range,
    as the two nest: the constructor's and the cost's spans run inside
    the benchmark's wrapper, so each lies inside its range; the
    estimation's, the LQR's and the rollout's wrap the benchmark's
    (the estimation's two: the sweep and decouple_AB), so each holds
    them.  Either way within NEAR_S at both ends: a mapping off by more
    breaks one side or the other."""
    m = program_trace.marked(run)
    assert m is not None
    ranges = {}
    for r in run.marked.ranges:
        ranges.setdefault(r.name[len("bench/"):], []).append(r)
    seen = {}
    for s in m.spans:
        if s.name not in RANGED or s.name not in ranges:
            continue
        if s.name in ("plan_init", "cost"):
            mine = [r for r in ranges[s.name]
                    if r.start - NEAR_S <= s.start
                    and s.end <= r.end + NEAR_S]
            assert len(mine) == 1, (s, "not inside one range")
        else:
            mine = [r for r in ranges[s.name]
                    if s.start - NEAR_S <= r.start
                    and r.end <= s.end + NEAR_S]
            assert len(mine) == (2 if s.name == "estimation" else 1), \
                (s, "not holding its ranges")
        seen[s.name] = seen.get(s.name, 0) + 1
    return seen


@pytest.mark.parametrize("name", CELLS)
def test_mapped_spans_lie_on_their_ranges_on_the_cpu(name, monkeypatch):
    c = harness.cell(name)
    config = dict(c.config, T=6, num_samples=8)
    if "cem" in config:
        config["cem"] = dict(config["cem"], batch_size=40, n_elite=10)
    c = c._replace(config=config, mix=dict(c.mix, iterations_per_plan=3))
    seen = _spans_lie_on_their_ranges(_traced_plan(c, "cpu", monkeypatch))
    # The benchmark ranges the rollout only where it is K4, on the card.
    want = {"plan_init", "cost"}
    if c.mix["solver"] != "cem":
        want |= {"estimation", "lqr"}
    assert set(seen) == want


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_mapped_spans_lie_on_their_ranges(name, card, monkeypatch):
    """A traced plan at the cell's own size on the card."""
    run = _traced_plan(harness.cell(name), card, monkeypatch)
    assert run.marked.device
    seen = _spans_lie_on_their_ranges(run)
    assert seen["plan_init"] == 1 and seen["rollout"] >= 1
    assert seen["cost"] == 1 + (2 if "cem" in name else 1) * \
        run.mix["iterations_per_plan"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_every_synchronising_call_is_a_sync_span(name, card):
    """One iteration at the cell's configuration under the sync debug
    mode: as many synchronising calls as ``sync`` spans.  A warm
    iteration first, so that nothing is loaded or cached in the one
    counted."""
    c = harness.cell(name)
    p = Program(c.config, c.mix, card)
    pl = traffic.plan(c.mix, c.config["nq"], SEED, 0)
    solver = p.solver(problem.make(c.config, c.mix, pl), pl.solver_seed)
    solver.iterate(1, verbose=False)
    torch.cuda.synchronize()
    timing.reset()
    waits = []

    def seen(message, *args, **kwargs):
        """Each wait with the span open at it and where it was called."""
        if "called a synchronizing CUDA operation" in str(message):
            stack = timing.TRACER._stack
            inner = timing.records()[stack[-1]].name if stack else None
            waits.append((inner, traceback.format_stack(limit=8)[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with timing.tracing():
                solver.iterate(1, verbose=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    spans = [r for r in timing.records() if r.name == "sync"]
    missed = [stack for inner, stack in waits if inner != "sync"]
    assert not missed, "".join(missed[0])
    assert len(waits) == len(spans) >= 1
