"""The rollout route of ``System``, one rule for ``rollout`` and
``rollout_lanes``: float32 tensors on the card run the system's
whole-chain kernel (K4), all chains in one launch, ``rollout``'s as
open-loop lanes; CPU tensors, float64 tensors and systems without the
kernel step the warm chain knot by knot.  On the CPU the kernel's source runs through the
g++ emulation of ``irs_mpc_torch.tools.cpu_shim`` with the device rule
patched to the card's; ``test_torch_kernels.py`` holds the route against
the plain chain on the card itself."""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import irs_mpc_torch  # noqa: E402
from irs_mpc_torch import IrsMpc  # noqa: E402
from irs_mpc_torch.models.contact import cuda_rollout  # noqa: E402
from irs_mpc_torch.ops import _nvcc  # noqa: E402
from irs_mpc_torch.utils import timing  # noqa: E402

T = 4
SOLVERS = {
    "box_pushing": lambda: chip_smoke.box_pushing_solver(
        "cpu", T=T, num_samples=4),
    "planar_hand": lambda: chip_smoke.planar_hand_solver(
        "cpu", T=T, num_samples=4),
}


@pytest.fixture(scope="module")
def rollout_shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the CPU emulation of the kernels")
    from irs_mpc_torch.tools import cpu_shim
    return cpu_shim.build_all([_nvcc.CSRC / "rollout.cu"],
                              tmp_path_factory.mktemp("shim"))[0]


@pytest.fixture(autouse=True)
def _empty_tracer():
    timing.reset()
    yield
    timing.reset()


def _warm_chain(system, x0, u_trj):
    """The warm chain knot by knot, as ``System.rollout`` steps it off the
    kernel route."""
    x = x0.expand(u_trj.shape[:-2] + x0.shape)
    xs = [x]
    if system.step_ws_fn is None:
        for t in range(u_trj.shape[-2]):
            x = system.step(x, u_trj[..., t, :])
            xs.append(x)
    else:
        ws = system.ws_init_fn(x0.device)
        for t in range(u_trj.shape[-2]):
            x, ws = system.step_ws_fn(x, u_trj[..., t, :], ws)
            xs.append(x)
    return torch.stack(xs, dim=-2)


def _chains():
    """The ``chain`` spans recorded so far."""
    return [r for r in timing.records() if r.name == "chain"]


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_constructor_rolls_out_through_one_k4_launch_on_cpu_shim(
        rollout_shim, monkeypatch, name):
    """What the card runs in the iRS constructor: the initial guess as one
    K4 lane (its source on the CPU shim), within the chain check's
    tolerance of the plain warm chain and at its cost; and chains over
    leading dims (2, 3) through one launch, in their shape."""
    from irs_mpc_torch.tools import cpu_shim
    plain, _ = SOLVERS[name]()
    monkeypatch.setattr(_nvcc, "on_card", lambda t: True)
    with cpu_shim.attached(cuda_rollout, rollout_shim), timing.tracing():
        before = cuda_rollout.LAUNCHES
        card = IrsMpc(plain.system, plain.params, device="cpu")
        assert cuda_rollout.LAUNCHES == before + 1
        u = plain.u_trj + 0.05 * torch.randn(
            (2, 3) + tuple(plain.u_trj.shape),
            generator=torch.Generator().manual_seed(0))
        xs = plain.system.rollout(plain.x0, u)
        assert cuda_rollout.LAUNCHES == before + 2
    n = plain.system.dim_x
    np.testing.assert_allclose(card.x_trj.numpy(), plain.x_trj.numpy(),
                               atol=chip_smoke.CHAIN_ATOL)
    np.testing.assert_allclose(card.cost, plain.cost, rtol=1e-5)
    assert xs.shape == (2, 3, T + 1, n)
    np.testing.assert_allclose(
        xs.numpy(), _warm_chain(plain.system, plain.x0, u).numpy(),
        atol=chip_smoke.CHAIN_ATOL)
    assert [r.counts for r in _chains()] == [
        {"knots": T, "chain_kernel": 1}] * 2


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_line_search_lanes_through_one_k4_launch_on_cpu_shim(
        rollout_shim, monkeypatch, name):
    """What the card runs in an iteration's line search: the arguments
    ``IrsMpc`` gives ``rollout_lanes`` (every alpha a lane, feedback on
    z = [x; u_prev], the rel and abs input boxes), recorded from a plain
    iteration, go through one K4 launch (its source on the CPU shim) with
    those arguments unchanged, within the chain check's tolerance of the
    plain loop's lanes."""
    from irs_mpc_torch.tools import cpu_shim
    solver, _ = SOLVERS[name]()
    calls, got = [], []
    lanes = irs_mpc_torch.models.base.System.rollout_lanes

    def recording(self, *args):
        out = lanes(self, *args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(irs_mpc_torch.models.base.System, "rollout_lanes",
                        recording)
    solver.iterate(1, verbose=False)
    monkeypatch.undo()
    (args, (xs_plain, us_plain)), = calls
    assert args[4] is not None and args[5].shape[0] == len(solver._alphas)
    k4 = solver.system.ls_rollout_fn

    def recording_k4(*a):
        got.append(a)
        return k4(*a)

    system = dataclasses.replace(solver.system, ls_rollout_fn=recording_k4)
    monkeypatch.setattr(_nvcc, "on_card", lambda t: True)
    with cpu_shim.attached(cuda_rollout, rollout_shim):
        before = cuda_rollout.LAUNCHES
        xs, us = system.rollout_lanes(*args)
        assert cuda_rollout.LAUNCHES == before + 1
    assert all(a is b for a, b in zip(got[0], args))
    assert xs.shape == xs_plain.shape and us.shape == us_plain.shape
    assert (xs - xs_plain).abs().max().item() < chip_smoke.CHAIN_ATOL
    assert (us - us_plain).abs().max().item() < chip_smoke.CHAIN_ATOL


def _float64():
    """The pendulum with a whole-chain rollout that must not be called,
    in float64."""
    system, x0, u = _pendulum()

    def ls_rollout_fn(*args):
        raise AssertionError("float64 took the kernel route")

    return (dataclasses.replace(system, ls_rollout_fn=ls_rollout_fn),
            x0.double(), u.double())


def _cpu():
    solver, _ = chip_smoke.box_pushing_solver("cpu", T=T, num_samples=4)
    return solver.system, solver.x0, solver.u_trj


def _pendulum():
    system = irs_mpc_torch.make_pendulum(0.05)
    u = torch.linspace(-0.5, 0.5, T)[:, None]
    return system, torch.tensor([0.1, 0.0]), u


def _plate_pickup():
    solver, _ = chip_smoke.plate_pickup_solver("cpu", T=T, num_samples=4)
    assert solver.system.ls_rollout_fn is None     # chain_gate refuses
    return solver.system, solver.x0, solver.u_trj


def _open_loop_lanes(system, x0, u):
    """``rollout_lanes`` with zero gains and infinite bounds: the
    open-loop chains of the lanes ``u`` (A, T, m), whose inputs it must
    leave as they are."""
    A, T_, m = u.shape
    n = system.dim_x

    def zeros(*shape):
        return torch.zeros(shape, dtype=x0.dtype)

    inf = torch.full((T_, m), torch.inf, dtype=x0.dtype)
    xs, us = system.rollout_lanes(x0, zeros(m), zeros(T_, m, n),
                                  zeros(A, T_, n), None, u, -inf, inf, None,
                                  None)
    assert torch.equal(us, u)
    return xs


@pytest.mark.parametrize("route", ["rollout", "rollout_lanes"])
@pytest.mark.parametrize("case, card_rule", [
    ("cpu", False), ("float64", True), ("no_kernel", True),
    ("chain_gate", True)])
def test_plain_chain_where_the_kernel_route_does_not_apply(
        monkeypatch, case, card_rule, route):
    """CPU tensors, float64 tensors under the card's device rule (the
    pendulum given a whole-chain rollout that raises) and systems without
    a whole-chain kernel (the pendulum; plate pickup, whose prismatic
    fingers ``chain_gate`` refuses) step the warm chain, through
    ``rollout`` and through ``rollout_lanes``'s plain loop alike: no K4
    launch, the chain's states bit for bit; ``rollout``'s span ``chain``
    counting its knots and no ``chain_kernel``, ``rollout_lanes`` opening
    no span of its own."""
    system, x0, u = {"cpu": _cpu, "float64": _float64,
                     "no_kernel": _pendulum,
                     "chain_gate": _plate_pickup}[case]()
    if card_rule:
        monkeypatch.setattr(_nvcc, "on_card", lambda t: True)
    u = u.expand((2,) + tuple(u.shape))
    before = cuda_rollout.LAUNCHES
    with timing.tracing():
        if route == "rollout":
            xs = system.rollout(x0, u)
        else:
            xs = _open_loop_lanes(system, x0, u)
    assert cuda_rollout.LAUNCHES == before
    assert xs.dtype == x0.dtype and xs.shape == (2, T + 1, system.dim_x)
    assert torch.equal(xs, _warm_chain(system, x0, u))
    assert [r.counts for r in _chains()] == (
        [{"knots": T}] if route == "rollout" else [])
