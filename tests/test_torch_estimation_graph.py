"""The zero-order estimation sweep's route: on float32 CUDA tensors a
system's fused sweep (``est_sweep_fn``), its fits and c run as one CUDA
graph replay (``estimators.SweepGraph``), captured once for each sweep
function, mode and shape; zero_order_B's A, where it is needed, is made
eagerly before it; every other call runs the eager code.

On the CPU the device rule is patched to the card's inside the estimator
alone: the calls the route must leave eager are held bit for bit to the
unpatched call, and a stand-in graph (which reruns the captured function
on its static inputs at every call) shows the cache, the counters and the
copies in and out.  The tests marked ``skipif`` need a CUDA device and
hold the real graph to the eager sweep bit for bit; run them on a machine
with an H100 with

    python -m pytest --noconftest tests/test_torch_estimation_graph.py -q
"""
import dataclasses
import gc
import types
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from irs_mpc_torch import IrsMpc  # noqa: E402
from irs_mpc_torch.models.contact import cuda_qp  # noqa: E402
from irs_mpc_torch.ops import estimators  # noqa: E402
from irs_mpc_torch.utils import timing  # noqa: E402

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

T, S = 4, 4
SOLVERS = {"box_pushing": chip_smoke.box_pushing_solver,
           "planar_hand": chip_smoke.planar_hand_solver}
# The cells' shapes on the card.
CARD_SHAPES = {"box_pushing": dict(T=60, num_samples=100),
               "planar_hand": dict(T=30, num_samples=50)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """An empty graph cache and tracer for each test."""
    monkeypatch.setattr(estimators, "SWEEP_GRAPHS",
                        weakref.WeakKeyDictionary())
    timing.reset()
    yield
    timing.reset()


class StandIn:
    """A graph in the shape of ``SweepGraph`` for the CPU: static input
    buffers, and at every call the captured function rerun on them (what
    a replay computes), its outputs cloned."""
    made = []

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = {k: t.clone() for k, t in inputs.items()}
        StandIn.made.append(self)

    def __call__(self, **inputs):
        for k, t in inputs.items():
            self.inputs[k].copy_(t)
        return tuple(t.clone() for t in self.fn(**self.inputs))


class Holds:
    """A stand-in that, as ``SweepGraph``, keeps no reference to what it
    captured: its calls return the capture's outputs."""

    def __init__(self, fn, inputs):
        self.outputs = fn(**inputs)

    def __call__(self, **inputs):
        return tuple(t.clone() for t in self.outputs)


class Refused:
    def __init__(self, fn, inputs):
        raise AssertionError("an eager call took the graph route")


def _on_card(monkeypatch):
    """The card's device rule, inside the estimator only."""
    monkeypatch.setattr(estimators, "_nvcc",
                        types.SimpleNamespace(on_card=lambda t: True))


def _solver(name, **kw):
    solver, _ = SOLVERS[name]("cpu", T=T, num_samples=S, **kw)
    return solver


def _estimate(system, mode, solver, x, u, need_A, dtype=torch.float32):
    """One estimation inside an ``estimation`` span, on draws made from a
    fixed seed in ``dtype``; returns (A, B, c, f_nom) and the span's
    counts."""
    cfg = solver.params.smoothing
    g = torch.Generator().manual_seed(7)
    draws = tuple(d.to(dtype) for d in estimators._draws(
        system, x, g, 2, cfg, None))
    with timing.tracing(), timing.span("estimation") as rec:
        tv, f_nom = estimators.estimate_tv_matrices_fnom(
            system, mode, x.to(dtype), u.to(dtype), None, 2, cfg,
            perturbations=draws, need_A=need_A)
    return (tv.A, tv.B, tv.c, f_nom), rec.counts


def _eager_case(name, case):
    """(system, mode, need_A, dtype) of a call the route leaves eager."""
    solver = _solver(name)
    sur = solver.params.estimation_system
    return {
        "float64": (sur, "zero_order_B", False, torch.float64),
        "flat": (sur, "first_order", False, torch.float32),
        "no_sweep_fn": (solver.system, "zero_order_B", False,
                        torch.float32),
        "cpu": (sur, "zero_order", False, torch.float32),
    }[case], solver


@pytest.mark.parametrize("case", ["float64", "flat", "no_sweep_fn", "cpu"])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_eager_calls_keep_the_eager_code_bit_for_bit(name, case,
                                                     monkeypatch):
    """Float64 tensors, the flat path (first_order) and a system without
    a fused sweep run eagerly even where the device rule says card: bit
    for bit the unpatched call, no graph made and nothing counted.  CPU
    tensors (the unpatched rule) take no graph either."""
    (system, mode, need_A, dtype), solver = _eager_case(name, case)
    x, u = solver.x_trj, solver.u_trj
    monkeypatch.setattr(estimators, "SweepGraph", Refused)
    want, counts = _estimate(system, mode, solver, x, u, need_A, dtype)
    assert counts is None
    if case != "cpu":
        _on_card(monkeypatch)
    got, counts = _estimate(system, mode, solver, x, u, need_A, dtype)
    assert counts is None
    assert not estimators.SWEEP_GRAPHS
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


ROUTED = [("zero_order_B", False), ("zero_order_B", True),
          ("zero_order", False), ("zero_order_AB", False)]


@pytest.mark.parametrize("mode, need_A", ROUTED)
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_graph_route_copies_in_and_out(name, mode, need_A, monkeypatch):
    """The route's plumbing around a stand-in graph on the CPU: the same
    A, B, c and f_nom as the eager sweep on the same draws, bit for bit,
    in every zero-order mode and with zero_order_B's A (made eagerly,
    then copied in), over calls on new nominals; one capture, then one
    replay a call; what a call returned is not touched by the next."""
    solver = _solver(name)
    sur = solver.params.estimation_system
    x, u = solver.x_trj, solver.u_trj
    want = [_estimate(sur, mode, solver, x + 0.01 * k, u, need_A)[0]
            for k in range(3)]
    if need_A:
        assert want[0][0].abs().sum() > 0
    _on_card(monkeypatch)
    monkeypatch.setattr(estimators, "SweepGraph", StandIn)
    StandIn.made = []
    got = []
    for k in range(3):
        out, counts = _estimate(sur, mode, solver, x + 0.01 * k, u, need_A)
        assert counts == ({"est_graph": 1, "est_capture": 1} if k == 0
                          else {"est_graph": 1})
        got.append(out)
    assert len(StandIn.made) == 1
    assert [len(g) for g in estimators.SWEEP_GRAPHS.values()] == [1]
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            assert torch.equal(g, w)


def _share(name, surrogates):
    """Solvers of ``name`` on the given estimation surrogates, one
    iteration each through a stand-in graph; the ``estimation`` spans'
    counts."""
    base = _solver(name)
    for sur in surrogates:
        params = dataclasses.replace(base.params, estimation_system=sur)
        solver = IrsMpc(base.system, params, device="cpu")
        with timing.tracing():
            solver.iterate(1, verbose=False)
    return [r.counts for r in timing.records() if r.name == "estimation"]


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_the_key_holds_the_sweep_function(name, monkeypatch):
    """Two solvers on one surrogate share one entry and capture once; two
    surrogates of one model (two sweep functions) get two entries."""
    _on_card(monkeypatch)
    monkeypatch.setattr(estimators, "SweepGraph", StandIn)
    base = _solver(name)
    sur = base.params.estimation_system
    counts = _share(name, [sur, sur])
    assert counts == [{"est_graph": 1, "est_capture": 1}, {"est_graph": 1}]
    (fn,) = estimators.SWEEP_GRAPHS.keys()
    assert fn is sur.est_sweep_fn and len(estimators.SWEEP_GRAPHS[fn]) == 1
    other = _solver(name).params.estimation_system
    assert other.est_sweep_fn is not sur.est_sweep_fn
    timing.reset()
    assert _share(name, [other]) == [{"est_graph": 1, "est_capture": 1}]
    assert len(estimators.SWEEP_GRAPHS) == 2


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_a_graph_goes_with_its_surrogate(name, monkeypatch):
    """The cache holds its sweep functions weakly: once a surrogate and
    its solvers are gone, so are its graphs; another's stay."""
    _on_card(monkeypatch)
    monkeypatch.setattr(estimators, "SweepGraph", Holds)
    kept, dropped = (_solver(name).params.estimation_system
                     for _ in range(2))
    _share(name, [kept, dropped])
    assert len(estimators.SWEEP_GRAPHS) == 2
    del dropped
    gc.collect()
    (fn,) = estimators.SWEEP_GRAPHS.keys()
    assert fn is kept.est_sweep_fn


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_solver(name):
    solver, _ = SOLVERS[name]("cuda", **CARD_SHAPES[name])
    return solver


def _nominals(solver, k):
    """The k-th nominal: the solver's, its inputs moved by a seeded
    draw."""
    g = torch.Generator(device="cuda").manual_seed(100 + k)
    u = solver.u_trj + 0.02 * torch.randn(solver.u_trj.shape, generator=g,
                                          device="cuda")
    return solver.system.rollout(solver.x0, u), u


CARD_ROUTES = [("zero_order_B", False), ("zero_order_B", True),
               ("zero_order_AB", False)]


@needs_cuda
@pytest.mark.parametrize("mode, need_A", CARD_ROUTES)
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_replays_match_the_eager_sweep_on_card(name, mode, need_A):
    """Three estimations on new nominals and new draws: A, B, c and f_nom
    bit for bit the eager sweep's on the same draws (the cells' mode,
    with and without its A, and one that samples the state too); K2's
    launch counter counts the first call's warm-up (2) and no replay;
    what the first call returned is unchanged after the third replay."""
    solver = _card_solver(name)
    sur, cfg = solver.params.estimation_system, solver.params.smoothing
    g = torch.Generator(device="cuda").manual_seed(3)
    first = None
    for k in range(3):
        x, u = _nominals(solver, k)
        draws = estimators._draws(sur, x, g, k + 1, cfg, None)
        before = cuda_qp.LAUNCHES
        with timing.tracing(), timing.span("estimation") as rec:
            tv, f_nom = estimators.estimate_tv_matrices_fnom(
                sur, mode, x, u, None, k + 1, cfg, perturbations=draws,
                need_A=need_A)
        torch.cuda.synchronize()
        assert cuda_qp.LAUNCHES - before == (2 if k == 0 else 0)
        assert rec.counts == ({"est_graph": 1, "est_capture": 1} if k == 0
                              else {"est_graph": 1})
        inputs = dict(x_nom=x[:-1], u_nom=u, du=draws[1])
        if mode != "zero_order_B":
            inputs["dx"] = draws[0]
        elif need_A:
            inputs["A"] = estimators._A_hat(sur, cfg, x[:-1], u, draws[1],
                                            True)
        AB, c, f = estimators._fused_tv(sur, mode, cfg, **inputs)
        n = sur.dim_x
        for got, want in ((tv.A, AB[:, :, :n]), (tv.B, AB[:, :, n:]),
                          (tv.c, c), (f_nom, f)):
            assert got.shape == want.shape and torch.equal(got, want)
        if k == 0:
            first = (tv, f_nom)
            kept = [t.clone() for t in (*tv, f_nom)]
    torch.cuda.synchronize()
    for got, want in zip((*first[0], first[1]), kept):
        assert torch.equal(got, want)


@needs_cuda
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_a_replay_runs_k2_twice_on_the_device_trace_on_card(name,
                                                            tmp_path):
    """A replay launches no K2 from the host, and the device trace holds
    K2's two kernels (the nominal and the sample solves) under its
    ``cudaGraphLaunch``, found by correlation id."""
    solver = _card_solver(name)
    solver.iterate(1, verbose=False)
    before = cuda_qp.LAUNCHES
    with timing.profile_trace(tmp_path):
        solver.iterate(2, verbose=False)
        torch.cuda.synchronize()
    assert cuda_qp.LAUNCHES == before
    ops = chip_smoke.trace_device_ops(tmp_path / "trace.json")
    k2 = [by for cat, name_, _, by in ops
          if cat == "kernel" and "pdip_kernel" in name_]
    assert k2 == ["cudaGraphLaunch"] * 4


@needs_cuda
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solvers_sharing_a_surrogate_capture_once_on_card(name):
    """Two solvers on one surrogate: one capture, then a replay in every
    iteration of either."""
    a = _card_solver(name)
    b = IrsMpc(a.system, a.params, device="cuda")
    with timing.tracing():
        a.iterate(2, verbose=False)
        b.iterate(2, verbose=False)
    counts = [r.counts for r in timing.records() if r.name == "estimation"]
    assert counts == [{"est_graph": 1, "est_capture": 1}] + \
        [{"est_graph": 1}] * 3
    assert len(estimators.SWEEP_GRAPHS) == 1
