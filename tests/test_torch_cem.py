"""Port parity: the CEM baseline of irs_mpc_torch against irs_mpc_tpu's, on
the CPU (the plain chains).

* One step with the JAX step's standard-normal draw injected (the
  ``noise=`` seam), from the same initial state: on the pendulum with every
  knob on (AR(1) noise, persisted elites, momentum, std floor, input box, a
  (T, m) initial std), on the pendulum with knot-interpolated noise, and on
  the two contact examples' small configurations, the planar hand
  (``tests/test_cem.py:50-59``: T=15, 50 candidates, 8 elites) and box
  pushing (T=15, 50 candidates, 5 elites).  The population's costs are held
  to the JAX package's rollout of the same candidates at rtol 1e-4; then
  the elite set (where the n_elite-th and next costs are apart by more
  than 2e-4, asserted), the refit mean and std and the kept elites at atol
  1e-5, and the accepted cost at rtol 1e-4.
  Contact candidates are held at 1e-4 where float32 determines their cost:
  where the port's float32 chain agrees with a float64 chain (the same
  warm steps in float64) to 1e-4.  On a few candidates a large first input
  jump makes the first warm knot's PDIP stall at a point that rounding
  decides (measured: 1 of 50 planar-hand candidates, 5 of 50 box-pushing
  ones, both packages off the float64 chain by up to 1.05e-2); those are
  counted, at most one more than measured (``EXEMPT``), and both packages'
  costs of them are held to the float64 chain's at rtol 2e-2.
* A population through ``System.rollout`` is the warm chains, equal to
  the JAX package's vmapped chains at atol 1e-5, and a system with a
  batched step (K2 on the card) scores it by the same warm chains, never
  by cold batched steps.
* The CEM configurations of ``chip_smoke`` are the JAX examples' (carried
  across with ``convert.cem_params_from_jax``), and their initial costs are
  the JAX package's at rtol 1e-5.
* The K4 route of the CEM population (K = 0, open-loop lanes) through
  K4's CUDA source on the CPU shim, against the plain chains.  The card
  cases (K4 on the planar-hand CEM's first population of 2000 lanes, the
  batched-step route through K2) are in ``tests/test_torch_kernels.py``,
  which runs on the card without JAX.
"""
import dataclasses
import importlib
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import chip_smoke  # noqa: E402
import irs_mpc_tpu as jmpc  # noqa: E402
import irs_mpc_torch as tmpc  # noqa: E402
from irs_mpc_tpu.solvers import cem as jcem  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.models.contact import cuda_qp, cuda_rollout  # noqa: E402
from irs_mpc_torch.ops import _nvcc  # noqa: E402

def _pendulum(T=30, **kw):
    base = dict(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([0.1]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)), n_elite=10, batch_size=100,
        initial_std=np.array([1.0]))
    base.update(kw)
    return jcem.CrossEntropyMethod(jmpc.make_pendulum(0.05),
                                   jcem.CemParams(**base)), None


def _example(module, **kw):
    return importlib.import_module(module).build_solver(**kw)


# Contact candidates whose float32 cost rounding decides (see the module
# docstring): at most one more than measured on each example.
EXEMPT = {"planar_hand": 2, "box_pushing": 6}

# case -> a builder of (JAX solver, JAX contact model or None)
STEP_CASES = {
    "pendulum_all_knobs": lambda: _pendulum(
        noise_beta=0.8, elite_keep=3, momentum=0.3,
        std_floor=np.array([0.05]), u_bounds_abs=np.array([[-1.5], [1.5]]),
        initial_std=np.linspace(0.5, 1.5, 30)[:, None], seed=2),
    "pendulum_noise_knots": lambda: _pendulum(
        noise_knots=6, elite_keep=2, momentum=0.1, seed=4),
    "planar_hand": lambda: _example("planar_hand_cem", T=15, batch_size=50,
                                    n_elite=8),
    "box_pushing": lambda: _example("box_pushing_cem", T=15, batch_size=50,
                                    n_elite=5),
}


def _port(jc, jm):
    system = (convert.model_from_jax(jm).system() if jm is not None
              else tmpc.make_pendulum(0.05))
    return tmpc.CrossEntropyMethod(system, convert.cem_params_from_jax(
        jc.params), device="cpu")


def _float64_costs(tc, model, cand):
    """The port's costs of ``cand`` with every warm step in float64."""
    ws = tuple(a.double() for a in model.ws_init())
    x = tc.x0.double().expand(cand.shape[0], -1)
    xs = [x]
    for t in range(cand.shape[1]):
        x, ws = model.step_ws(x, cand[:, t].double(), ws)
        xs.append(x)
    view = types.SimpleNamespace(
        Q=tc.Q.double(), Qd=tc.Qd.double(), R=tc.R.double(),
        xd_trj=tc.xd_trj.double(), idx_u=tc.idx_u, params=tc.params)
    return tmpc.CrossEntropyMethod.eval_cost(view, torch.stack(xs, dim=1),
                                             cand.double()).numpy()


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_injected_step_matches_jax(case):
    jc, jm = STEP_CASES[case]()
    tc = _port(jc, jm)
    np.testing.assert_allclose(tc.cost, jc.cost, rtol=1e-5)
    p = jc.params
    rows = p.noise_knots if p.noise_knots else tc.T
    _, k = jax.random.split(jc.key)
    eps = np.array(jax.random.normal(k, (p.batch_size, rows,
                                         jc.system.dim_u)))
    jc.iterate(1, verbose=False)
    st = tc._step(tc.u_trj, tc.std_trj, tc.x_trj, torch.tensor(tc.cost),
                  tc.kept, noise=torch.from_numpy(eps))

    # The population's costs: the JAX package's rollout of the same
    # candidates, as its step scores them.
    cand = jnp.asarray(st.cand.numpy())
    want = np.asarray(jax.vmap(
        lambda u: jc._cost(jc.system.rollout(jc.x0, u), u))(cand))
    got = st.costs.numpy()
    held = np.ones(len(got), bool)
    if jm is not None:
        c64 = _float64_costs(tc, convert.model_from_jax(jm), st.cand)
        held = np.abs(got - c64) <= 1e-4 * np.abs(c64)
        assert (~held).sum() <= EXEMPT[case], (~held).sum()
        for costs in (got, want):
            np.testing.assert_allclose(costs[~held], c64[~held], rtol=2e-2)
    np.testing.assert_allclose(got[held], want[held], rtol=1e-4)

    n = p.n_elite
    order = np.sort(want)
    assert order[n] - order[n - 1] > 2e-4 * abs(order[n])
    assert set(st.elite_idx.tolist()) == set(np.argsort(want)[:n].tolist())
    np.testing.assert_allclose(st.u.numpy(), np.asarray(jc.u_trj),
                               atol=1e-5)
    np.testing.assert_allclose(st.std.numpy(), np.asarray(jc.std_trj),
                               atol=1e-5)
    if p.elite_keep:
        np.testing.assert_allclose(st.kept.numpy(), np.asarray(jc.kept),
                                   atol=1e-5)
    np.testing.assert_allclose(float(st.cost), jc.cost, rtol=1e-4)


def test_param_validation():
    base = dict(Q=np.eye(2), Qd=np.eye(2), R=np.eye(1), x0=np.zeros(2),
                xd_trj=np.zeros((11, 2)), u_trj_init=np.zeros((10, 1)),
                n_elite=10, batch_size=20, initial_std=np.array([1.0]))
    for bad in [dict(momentum=1.0), dict(momentum=-0.1),
                dict(noise_beta=1.0), dict(noise_beta=-0.2),
                dict(elite_keep=11), dict(elite_keep=-1),
                dict(noise_knots=-1), dict(noise_knots=1),
                dict(noise_knots=11), dict(initial_std=np.ones((9, 1)))]:
        with pytest.raises(ValueError):
            tmpc.CrossEntropyMethod(tmpc.make_pendulum(0.05),
                                    tmpc.CemParams(**{**base, **bad}),
                                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmpc.CrossEntropyMethod(tmpc.make_pendulum(0.05),
                                    tmpc.CemParams(**base))


def test_divergent_mean_is_rejected():
    """The elites' mean can blow up where every elite was finite: the step
    falls back to the best elite, or to the previous mean (the JAX
    package's guard); the history stays finite."""
    def step(x, u):
        return torch.where(x.abs() > 2.0, x * x * 1e10, x + 0.1 * u)

    sys_ = tmpc.System(name="explosive", dim_x=1, dim_u=1, h=0.1, step=step)
    T = 20
    cem = tmpc.CrossEntropyMethod(sys_, tmpc.CemParams(
        Q=np.eye(1), Qd=np.eye(1), R=np.eye(1) * 1e-3, x0=np.zeros(1),
        xd_trj=np.tile([1.9], (T + 1, 1)), u_trj_init=np.zeros((T, 1)),
        n_elite=5, batch_size=50, initial_std=np.array([5.0])),
        device="cpu")
    cem.iterate(8, verbose=False)
    assert np.isfinite(cem.cost_lst).all(), cem.cost_lst
    assert np.isfinite(cem.cost_best)


def test_population_rollout_matches_jax():
    jm = jmpc.models.contact.systems.make_box_pushing()
    tm = convert.model_from_jax(jm)
    rng = np.random.RandomState(0)
    B, T = 6, 5
    x0 = np.array([0., 0.5, 0., 0., -0.12], np.float32)
    u_b = (np.tile(x0[tm.indices_u_into_x()], (B, T, 1))
           + rng.randn(B, T, 2) * 0.02).astype(np.float32)
    jx0, ju = jnp.asarray(x0), jnp.asarray(u_b)
    warm = np.asarray(jax.vmap(lambda u: jm.system().rollout(jx0, u))(ju))
    # The warm chains, all lanes at once.
    plain = tm.system()
    assert plain.step_batch_fn is None
    got = plain.rollout(torch.from_numpy(x0), torch.from_numpy(u_b))
    np.testing.assert_allclose(got.numpy(), warm, atol=1e-5)
    # A batched step does not change how a population is scored.
    routed = tm.system(batch_kernel=True)
    assert routed.step_batch_fn is not None
    before = cuda_qp.LAUNCHES
    assert torch.equal(routed.rollout(torch.from_numpy(x0),
                                      torch.from_numpy(u_b)), got)
    assert cuda_qp.LAUNCHES == before


def test_estimation_surrogate_takes_the_batched_step_route():
    jm = jmpc.models.contact.systems.make_planar_hand()
    tm = convert.model_from_jax(jm)
    sur = tm.estimation_surrogate()
    assert sur.step_batch_fn is not None and sur.est_sweep_fn is not None
    assert tm.system().step_batch_fn is None
    x = torch.tensor(chip_smoke.CONTACT_Q0["planar_hand"],
                     dtype=torch.float32).expand(4, -1)
    u = x[:, torch.from_numpy(tm.indices_u_into_x())] + 0.05
    np.testing.assert_array_equal(sur.step_batch(x, u).numpy(),
                                  sur.step(x, u).numpy())


# (chip_smoke builder, example module, its builder, small kwargs)
CONFIGS = {
    "planar_hand_cem": ("planar_hand_cem", "build_solver",
                        dict(T=6, batch_size=20, n_elite=4)),
    "box_pushing_cem": ("box_pushing_cem", "build_solver",
                        dict(T=6, batch_size=20, n_elite=4)),
    "box_pivoting_cem": ("box_pivoting", "build_cem_solver",
                         dict(T=6, batch_size=20, n_elite=4)),
    "bicycle_cem": ("bicycle", "build_cem_solver",
                    dict(hard=True, T=6, batch_size=20, n_elite=4)),
    # The second-order plant at the example's horizon (T=30).
    "planar_hand_second_cem": ("planar_hand_second_order",
                               "build_cem_solver",
                               dict(batch_size=20, n_elite=16)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_smoke_cem_configuration_is_the_example(name):
    module, fn, kw = CONFIGS[name]
    out = getattr(importlib.import_module(module), fn)(**kw)
    jc, jm = out if isinstance(out, tuple) else (out, None)
    out = getattr(chip_smoke, name)("cpu", **kw)
    tc, tm = out if isinstance(out, tuple) else (out, None)
    want = convert.cem_params_from_jax(jc.params)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(tc.params, f.name)
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64),
                                      err_msg=f.name)
    if jm is not None:
        # The CEM's own model: box pivoting's keeps its duals
        # uncanonicalised (the iRS factory's opt in), so chain_gate leaves
        # it without K4, as the JAX package's gate does; the second-order
        # plant has no whole-chain rollout in either package.
        if name == "planar_hand_second_cem":
            want_model = convert.system_from_jax(jm)
        else:
            want_model = convert.model_from_jax(jm)
        if name == "box_pivoting_cem":
            want_model = dataclasses.replace(want_model,
                                             canon_warm_duals=False)
        assert tm == want_model
        assert (tc.system.ls_rollout_fn is None) == (
            name in ("box_pivoting_cem", "planar_hand_second_cem"))
    np.testing.assert_allclose(tc.cost, jc.cost, rtol=1e-5)


def test_pendulum_cem_configuration_and_initial_costs():
    """The pendulum CEM of ``examples/pendulum.py:49-55`` (built inline
    there) and the float32 initial costs ``chip_smoke`` holds the card
    to, each what the JAX package computes on the CPU."""
    T = 200
    jc = jcem.CrossEntropyMethod(jmpc.make_pendulum(0.05), jcem.CemParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), n_elite=80, batch_size=8000,
        initial_std=np.array([1.0]), elite_keep=10, noise_knots=40))
    tc = chip_smoke.pendulum_cem("cpu")
    want = convert.cem_params_from_jax(jc.params)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f.name), np.float64),
            np.asarray(getattr(tc.params, f.name), np.float64),
            err_msg=f.name)
    initial = {case[0]: case[3] for case in chip_smoke.CEM_CASES}
    np.testing.assert_allclose(tc.cost, jc.cost, rtol=1e-5)
    np.testing.assert_allclose(jc.cost, initial["pendulum_cem"], rtol=1e-5)
    for label, module, fn, kw in (
            ("planar_hand_cem", "planar_hand_cem", "build_solver", {}),
            ("box_pushing_cem", "box_pushing_cem", "build_solver", {}),
            ("box_pivoting_cem", "box_pivoting", "build_cem_solver", {}),
            ("bicycle_hard_cem", "bicycle", "build_cem_solver",
             dict(hard=True))):
        out = getattr(importlib.import_module(module), fn)(**kw)
        jc = out[0] if isinstance(out, tuple) else out
        np.testing.assert_allclose(jc.cost, initial[label], rtol=1e-5,
                                   err_msg=label)


@pytest.fixture(scope="module")
def rollout_shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the CPU emulation of the kernels")
    from irs_mpc_torch.tools import cpu_shim
    return cpu_shim.build_all([_nvcc.CSRC / "rollout.cu"],
                              tmp_path_factory.mktemp("shim"))[0]


def test_cem_population_route_through_k4_source_on_cpu_shim(rollout_shim,
                                                            monkeypatch):
    """What the card runs for a contact CEM: the population and the mean
    through K4 (its source on the CPU shim), one launch each, K = 0,
    against the warm chains of ``System.rollout`` at the chain check's
    tolerance.  The population is one ``chain`` of ``System.rollout``
    inside CEM's ``rollout`` span, and its ``z_ref_x`` is the route's
    cached contiguous constant, which K4's wrapper takes without a copy."""
    from irs_mpc_torch.tools import cpu_shim
    from irs_mpc_torch.utils import timing
    cem, model = chip_smoke.planar_hand_cem("cpu", T=3, batch_size=4,
                                            n_elite=2)
    cand = cem.u_trj + 0.05 * torch.randn(
        (4, 3, 4), generator=torch.Generator().manual_seed(0))
    want = cem.system.rollout(cem.x0, cand)
    calls = []
    k4 = cem.system.ls_rollout_fn

    def recording(*args):
        calls.append(args)
        return k4(*args)

    cem.system = dataclasses.replace(cem.system, ls_rollout_fn=recording)
    monkeypatch.setattr(_nvcc, "on_card", lambda t: True)
    timing.reset()
    with cpu_shim.attached(cuda_rollout, rollout_shim), timing.tracing():
        before = cuda_rollout.LAUNCHES
        got = cem.rollout(cand)
        assert cuda_rollout.LAUNCHES == before + 1
        recs = timing.records()
        chains = [r for r in recs if r.name == "chain"]
        assert [r.counts for r in chains] == [
            {"knots": 3, "chain_kernel": 1}]
        assert recs[chains[0].parent].name == "rollout"
        cuda_rollout.LAUNCHES = 0
        st = cem._step(cem.u_trj, cem.std_trj, cem.x_trj,
                       torch.tensor(cem.cost), cem.kept)
        assert cuda_rollout.LAUNCHES == 2      # the population, the mean
    timing.reset()
    z_ref_x = calls[0][3]
    assert z_ref_x.shape == (4, 3, model.nq) and z_ref_x.is_contiguous()
    assert calls[1][3] is z_ref_x              # the population again
    assert not calls[0][2].any()               # K = 0
    assert got.shape == (4, 4, model.nq)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=chip_smoke.CHAIN_ATOL)
    assert torch.isfinite(st.costs).all()

