"""The iRS constructor's dynamics probe (``IrsMpc._probe``): one ``step``
at x = 0, u = 0, run once for each system and device in the process
(``irs_mpc.PROBED``) and skipped by every later constructor on the same
pair, which counts ``probe_reused`` on its ``plan_init`` span.  A probe
that fails is not recorded, so it raises at every constructor.  Plans
from a system whose probe is reused are bit for bit those from a new
system of the same model.

The tests marked ``skipif`` need a CUDA device: a system that passed on
the CPU is probed again on the card, ``cuda`` and ``cuda:0`` are one
entry, and whole plans at the benchmark cells' shapes are bit for bit
with and without the probe.  Run them on a machine with an H100 with

    python -m pytest --noconftest tests/test_torch_probe.py -q
"""
import dataclasses
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_torch import IrsMpc, make_pendulum  # noqa: E402
from irs_mpc_torch.examples import (box_pushing, pendulum,  # noqa: E402
                                    planar_hand)
from irs_mpc_torch.solvers import irs_mpc  # noqa: E402
from irs_mpc_torch.utils import timing  # noqa: E402

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

PENDULUM_T = 20


def _pendulum():
    """(a new pendulum system, its params), zero-order at a small size."""
    return make_pendulum(0.05), pendulum.build_params(
        "zero_order", T=PENDULUM_T, num_samples=16)


def _planar_hand(T=4, num_samples=4, device="cpu"):
    """(a new planar-hand system, its params), the example's problem."""
    solver, model = planar_hand.build_solver(T=T, num_samples=num_samples,
                                             device=device)
    return model.system(), solver.params


MODELS = {"pendulum": _pendulum, "planar_hand": _planar_hand}
# Steps a CPU constructor takes besides the probe: the pendulum's initial
# rollout steps ``step`` knot by knot; the planar hand's runs the warm
# chain (``step_ws_fn``).
ROLLOUT_STEPS = {"pendulum": PENDULUM_T, "planar_hand": 0}


@pytest.fixture(autouse=True)
def _empty_tracer():
    timing.reset()
    yield
    timing.reset()


def _counted(system, step=None):
    """``system`` rebuilt with its ``step`` (or ``step``) behind a
    counter; returns (the new system, the list of calls)."""
    calls = []
    inner = step or system.step

    def counting(x, u):
        calls.append(tuple(x.shape))
        return inner(x, u)

    return dataclasses.replace(system, step=counting), calls


@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_second_constructor_on_a_system_does_not_step(name):
    """The first constructor on a system steps it once more than its
    rollout does (the probe); the second and third, on the same system
    and device, not at all beyond their rollouts; a new system of the
    same model is probed again."""
    base, params = MODELS[name]()
    system, calls = _counted(base)
    counts = []
    for _ in range(3):
        before = len(calls)
        IrsMpc(system, params, device="cpu")
        counts.append(len(calls) - before)
    rollout = ROLLOUT_STEPS[name]
    assert counts == [rollout + 1, rollout, rollout]
    assert irs_mpc.PROBED[system] == {torch.device("cpu")}
    other, other_calls = _counted(base)
    IrsMpc(other, params, device="cpu")
    assert len(other_calls) == rollout + 1


def _same_plan(a, b):
    """Two solvers' plans are equal bit for bit: every iterate, cost and
    best."""
    assert len(a.x_trj_lst) == len(b.x_trj_lst)
    for xa, xb in zip(a.x_trj_lst + a.u_trj_lst, b.x_trj_lst + b.u_trj_lst):
        assert torch.equal(xa, xb)
    assert a.cost_lst == b.cost_lst and a.cost_best == b.cost_best
    assert torch.equal(a.x_trj_best, b.x_trj_best)
    assert torch.equal(a.u_trj_best, b.u_trj_best)
    assert ([dataclasses.replace(s, wall_time=0) for s in a.stats_lst]
            == [dataclasses.replace(s, wall_time=0) for s in b.stats_lst])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_plans_with_the_probe_reused_equal_new_systems(name):
    """Two iterations from a system whose probe an earlier constructor
    ran are bit for bit two iterations from a new system of the same
    model, whose constructor probes."""
    system, params = MODELS[name]()
    IrsMpc(system, params, device="cpu")
    with timing.tracing():
        reused = IrsMpc(system, params, device="cpu")
    assert timing.counted("plan_init") == {"probe_reused": 1}
    fresh = IrsMpc(MODELS[name]()[0], params, device="cpu")
    reused.iterate(2, verbose=False)
    fresh.iterate(2, verbose=False)
    _same_plan(reused, fresh)


def _raises(x, u):
    raise NotImplementedError("no dynamics")


def _wrong_shape(x, u):
    return x[..., :1]


@pytest.mark.parametrize("step, cause", [(_raises, NotImplementedError),
                                         (_wrong_shape, ValueError)],
                         ids=["raises", "wrong_shape"])
def test_a_failing_probe_raises_at_every_constructor(step, cause):
    """A step that raises, or returns the wrong shape, fails the probe of
    every constructor, each chained from its cause; nothing is
    recorded for the system."""
    base, params = _pendulum()
    system, calls = _counted(base, step)
    for k in range(3):
        with pytest.raises(RuntimeError,
                           match="Could not evaluate dynamics") as info:
            IrsMpc(system, params, device="cpu")
        assert isinstance(info.value.__cause__, cause)
        assert len(calls) == k + 1
    assert system not in irs_mpc.PROBED


@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_probe_span_and_the_reuse_counter(name):
    """Traced, the first constructor holds a ``probe`` span under its
    ``plan_init`` and counts nothing there; the second holds no probe
    span and counts ``probe_reused`` 1 on its ``plan_init``."""
    system, params = MODELS[name]()
    with timing.tracing():
        first = IrsMpc(system, params, device="cpu")
        second = IrsMpc(system, params, device="cpu")
    recs = timing.records()
    inits = {r.plan: i for i, r in enumerate(recs) if r.name == "plan_init"}
    assert sorted(inits) == sorted([first.plan, second.plan])
    probes = [r for r in recs if r.name == "probe"]
    assert len(probes) == 1 and probes[0].parent == inits[first.plan]
    assert probes[0].plan == first.plan and probes[0].counts is None
    assert not (recs[inits[first.plan]].counts or {}).get("probe_reused")
    assert recs[inits[second.plan]].counts == {"probe_reused": 1}


def test_the_record_goes_with_its_system():
    """The record holds its systems weakly: once a system and its
    solvers are gone, so is its entry."""
    system, params = _pendulum()
    solver = IrsMpc(system, params, device="cpu")
    assert system in irs_mpc.PROBED
    ref = weakref.ref(system)
    del system, solver
    gc.collect()
    assert ref() is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@needs_cuda
def test_the_card_is_probed_apart_from_the_cpu_on_card():
    """A system that passed on the CPU is probed again on the card; then
    ``cuda``, ``cuda:0`` and ``torch.device("cuda", 0)`` share one
    entry."""
    system, params = _pendulum()
    with timing.tracing():
        for device in ("cpu", "cuda", "cuda:0", torch.device("cuda", 0),
                       "cpu"):
            IrsMpc(system, params, device=device)
    recs = timing.records()
    inits = [r for r in recs if r.name == "plan_init"]
    assert [bool((r.counts or {}).get("probe_reused")) for r in inits] == [
        False, False, True, True, True]
    assert sum(r.name == "probe" for r in recs) == 2
    assert irs_mpc.PROBED[system] == {torch.device("cpu"),
                                      torch.device("cuda", 0)}


def _card_problem(name):
    """(a new system, its params) at the benchmark cells' shapes."""
    if name == "box_pushing":
        model, params = box_pushing.build_problem("zero_order_B", 100, 60,
                                                  "anitescu")
        return model.system(), params
    return _planar_hand(T=30, num_samples=50, device="cuda")


@needs_cuda
@pytest.mark.parametrize("name", ["box_pushing", "planar_hand"])
def test_a_whole_plan_with_the_probe_reused_on_card(name):
    """A whole plan (21 iterations) from a constructor that reused the
    probe is bit for bit the plan from one that ran it, on one seed."""
    system, params = _card_problem(name)
    with timing.tracing():
        probed = IrsMpc(system, params, device="cuda")
        reused = IrsMpc(system, params, device="cuda")
    counts = [r.counts for r in timing.records() if r.name == "plan_init"]
    assert [bool((c or {}).get("probe_reused")) for c in counts] == [
        False, True]
    probed.iterate(21, verbose=False)
    reused.iterate(21, verbose=False)
    _same_plan(probed, reused)
