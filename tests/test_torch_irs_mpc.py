"""Port parity: irs_mpc_torch.IrsMpc against irs_mpc_tpu.IrsMpc.

* One iteration with injected samples: a JAX solver runs one iteration, its
  state is carried into the port (``convert.state_from_jax``), and both run
  the next iteration on the same perturbations (drawn as the JAX iteration
  draws them).  Cost channels rtol 1e-4, trajectories atol 1e-3 (float32
  round-off through a 200-knot fit, Riccati pass and feedback rollout).
* The port's own random stream, at full width, held to the pendulum goldens
  of ``tests/test_irs_mpc.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import irs_mpc_tpu as jmpc  # noqa: E402
import irs_mpc_torch as tmpc  # noqa: E402
from irs_mpc_tpu.ops.estimators import _sample_perturbations  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.ops import cuda_riccati  # noqa: E402

T, S = 200, 1000


def _params(pkg, mode, T=T, **kw):
    return pkg.IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode=mode,
        smoothing=pkg.SmoothingConfig(num_samples=S, std_x=1.0, std_u=1.0),
        **kw)


def _jax_iteration_draws(solver):
    """The (dx, du) that ``solver``'s next JAX iteration draws."""
    p = solver.params
    _, k_est = jax.random.split(solver.key)
    sx, su = p.smoothing.stds(jnp.asarray(solver.iter, jnp.float32), 2, 1)
    keys = jax.random.split(k_est, solver.T)
    dx, du = jax.vmap(lambda k: _sample_perturbations(
        k, sx, su, p.smoothing.num_samples))(keys)
    return torch.from_numpy(np.array(dx)), torch.from_numpy(np.array(du))


def test_injected_iteration_matches_jax():
    jp = _params(jmpc, "zero_order")
    js = jmpc.IrsMpc(jmpc.make_pendulum(0.05), jp)
    js.iterate(1, verbose=False)
    draws = _jax_iteration_draws(js)
    jx, ju, _, jcvec = js._iteration_jit(
        js.x_trj, js.u_trj, js.key, jnp.asarray(js.iter, jnp.float32))
    jcvec = np.asarray(jcvec)

    ts = tmpc.IrsMpc(tmpc.make_pendulum(0.05), convert.params_from_jax(jp),
                     device="cpu")
    convert.state_from_jax(js, ts)
    assert ts.iter == 2 and ts.cost == js.cost and len(ts.cost_lst) == 2
    np.testing.assert_array_equal(ts.x_trj.numpy(), np.asarray(js.x_trj))
    step = ts._iteration(ts.x_trj, ts.u_trj, ts.iter, perturbations=draws)

    np.testing.assert_allclose(step.cvec.numpy(), jcvec, rtol=1e-4)
    np.testing.assert_allclose(step.x.numpy(), np.asarray(jx), atol=1e-3)
    np.testing.assert_allclose(step.u.numpy(), np.asarray(ju), atol=1e-3)
    # The same step size won: JAX's accepted total matches the port's lane
    # ``best`` and is far from every other lane's total.
    totals = step.lane_costs[:, 0].numpy()
    best = int(step.best)
    assert best == int(np.argmin(totals))
    others = np.delete(totals, best)
    assert np.min(np.abs(others - jcvec[0])) > 100 * 1e-4 * jcvec[0]


@pytest.mark.parametrize("mode", ["exact", "first_order", "zero_order"])
def test_pendulum_converges_to_reference(mode):
    """The goldens of tests/test_irs_mpc.py with the port's own stream:
    initial 1856.1541, cost and best <= 360 after 8 descents."""
    s = tmpc.IrsMpc(tmpc.make_pendulum(0.05), _params(tmpc, mode),
                    device="cpu")
    assert abs(s.cost - 1856.1541) < 0.01
    before = cuda_riccati.LAUNCHES
    s.iterate(8, verbose=False)
    assert cuda_riccati.LAUNCHES == before
    assert s.cost <= 360.0
    assert s.cost_best <= 360.0


def test_delta_u_exact_curve_matches_jax():
    """Δu-cost mode (augmented state, cross term N) in exact mode, which
    draws no samples, so both packages follow the same curve."""
    kw = dict(indices_u_into_x=np.array([0]))
    jp = _params(jmpc, "exact", T=30, **kw)
    tp = _params(tmpc, "exact", T=30, **kw)
    js = jmpc.IrsMpc(jmpc.make_pendulum(0.05), jp)
    ts = tmpc.IrsMpc(tmpc.make_pendulum(0.05), tp, device="cpu")
    js.iterate(4, verbose=False)
    ts.iterate(4, verbose=False)
    assert ts.cost < ts.cost_lst[0]
    np.testing.assert_allclose(ts.cost_lst, js.cost_lst, rtol=1e-4)
    for a, b in zip(ts.stats_lst, js.stats_lst):
        np.testing.assert_allclose(
            [a.cost_Qu, a.cost_Qu_final, a.cost_Qa, a.cost_Qa_final,
             a.cost_R],
            [b.cost_Qu, b.cost_Qu_final, b.cost_Qa, b.cost_Qa_final,
             b.cost_R], rtol=1e-4, atol=1e-4)


def test_cost_channels_split_matches_jax():
    kw = dict(unactuated_indices=np.array([1]))
    js = jmpc.IrsMpc(jmpc.make_pendulum(0.05), _params(jmpc, "exact", T=20,
                                                         **kw))
    ts = tmpc.IrsMpc(tmpc.make_pendulum(0.05), _params(tmpc, "exact", T=20,
                                                         **kw),
                     device="cpu")
    want = [float(c) for c in js.eval_cost(js.x_trj, js.u_trj)]
    got = [float(c) for c in ts.eval_cost(ts.x_trj, ts.u_trj)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] > 0 and got[3] > 0


def test_history_and_best_tracking():
    s = tmpc.IrsMpc(tmpc.make_pendulum(0.05), _params(tmpc, "exact"),
                    device="cpu")
    seen = []
    s.params.iteration_callback = lambda it, x, u: seen.append(it)
    s.iterate(3, verbose=False)
    assert len(s.cost_lst) == 4 and len(s.x_trj_lst) == 4
    assert s.cost_best == min(s.cost_lst)
    assert s.stats_lst[0].cost == s.cost_lst[1]
    assert seen == [1, 2, 3] and s.iter == 4


@pytest.mark.parametrize("field, value", [
    ("forward_mode", "resolve"),
    ("parallel_riccati", True),
    ("mesh", object()),
])
def test_later_slices_raise_not_implemented(field, value):
    """The options of the later slices, each once refused with
    NotImplementedError, now run on the CPU: resolve
    (``tests/test_torch_resolve.py`` holds its curves to the JAX
    package's), the associative-scan Riccati pass and the sharded
    estimation (``tests/test_torch_assoc.py``, ``test_torch_parallel.py``);
    here each descends from the same start as the default options, the
    last two to the default's cost within 1e-4."""
    if field == "mesh":
        value = tmpc.make_mesh(2, 2, devices="cpu")
    params = _params(tmpc, "exact", T=10, **{field: value})
    s = tmpc.IrsMpc(tmpc.make_pendulum(0.05), params, device="cpu")
    s.iterate(2, verbose=False)
    assert np.isfinite(s.cost_lst).all() and len(s.cost_lst) == 3
    assert not torch.equal(s.u_trj, s.u_trj_lst[0])
    if field != "forward_mode":
        ref = tmpc.IrsMpc(tmpc.make_pendulum(0.05),
                          _params(tmpc, "exact", T=10), device="cpu")
        ref.iterate(2, verbose=False)
        np.testing.assert_allclose(s.cost_lst, ref.cost_lst, rtol=1e-4)


# Bounded pendulum solves (boxed ADMM, clipped feedback rollout): the
# bound kinds in plain-u mode, where u_bounds_rel augments the state with
# the previous input, and the trust-region input box in Δu mode.
BOUNDED = {
    "u_bounds_abs": dict(u_bounds_abs=np.array([[-1.5], [1.5]])),
    "x_bounds_rel": dict(x_bounds_rel=np.array([[-1., -1.], [1., 1.]])),
    "x_bounds_abs": dict(x_bounds_abs=np.array([[-1., -3.], [4., 3.]])),
    "u_bounds_rel": dict(u_bounds_rel=np.array([[-0.5], [0.5]]),
                         u_bounds_abs=np.array([[-2.], [2.]])),
    "delta_u_trust_region": dict(indices_u_into_x=np.array([0]),
                                 u_bounds_abs=np.array([[-0.3], [0.3]]),
                                 bounds_trust_region=True),
}


@pytest.mark.parametrize("case", list(BOUNDED))
def test_bounded_exact_curve_matches_jax(case):
    """Exact mode draws no samples, so both packages follow the same curve:
    cost curve and channels at rtol 1e-4 (as the unbounded Δu curve), the
    final plan at atol 1e-3, inside its input box.  No kernel is
    launched on CPU tensors."""
    kw = dict(BOUNDED[case], admm_iters=30, admm_over_relax=1.6)
    js = jmpc.IrsMpc(jmpc.make_pendulum(0.05),
                     _params(jmpc, "exact", T=20, **kw))
    ts = tmpc.IrsMpc(tmpc.make_pendulum(0.05),
                     _params(tmpc, "exact", T=20, **kw), device="cpu")
    assert ts._has_bounds()
    js.iterate(3, verbose=False)
    before = cuda_riccati.LAUNCHES
    ts.iterate(3, verbose=False)
    assert cuda_riccati.LAUNCHES == before
    assert ts.cost < ts.cost_lst[0]
    np.testing.assert_allclose(ts.cost_lst, js.cost_lst, rtol=1e-4)
    for a, b in zip(ts.stats_lst, js.stats_lst):
        np.testing.assert_allclose(
            [a.cost_Qu_final, a.cost_Qa, a.cost_Qa_final, a.cost_R],
            [b.cost_Qu_final, b.cost_Qa, b.cost_Qa_final, b.cost_R],
            rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.u_trj.numpy(), np.asarray(js.u_trj),
                               atol=1e-3)
    np.testing.assert_allclose(ts.x_trj.numpy(), np.asarray(js.x_trj),
                               atol=1e-3)
    if "u_bounds_abs" in kw and not kw.get("bounds_trust_region"):
        lb, ub = kw["u_bounds_abs"]
        u = ts.u_trj.numpy()
        assert (u >= lb - 1e-6).all() and (u <= ub + 1e-6).all()
    if "u_bounds_rel" in kw:
        du = np.diff(ts.u_trj.numpy(), axis=0)
        assert np.abs(du).max() <= 0.5 + 1e-5


def test_default_device_is_the_card():
    """Without a device the solver runs on CUDA; with no CUDA device that
    raises, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmpc.IrsMpc(tmpc.make_pendulum(0.05), _params(tmpc, "exact", T=10))


def test_params_from_jax_refuses_what_cannot_cross():
    jp = _params(jmpc, "zero_order", T=10)
    tp = convert.params_from_jax(jp)
    assert tp.smoothing.num_samples == S and tp.riccati_backend == "auto"
    assert tp.line_search_alphas == jp.line_search_alphas
    custom = jmpc.SmoothingConfig(decay=lambda it: 1.0 / it)
    with pytest.raises(ValueError, match="decay"):
        convert.params_from_jax(dataclasses.replace(jp, smoothing=custom))
    with pytest.raises(ValueError, match="mesh"):
        convert.params_from_jax(dataclasses.replace(jp, mesh=object()))
    # A closure decay crosses as its torch counterpart, handed in.
    decay = lambda it: 1.0 / it  # noqa: E731
    tp = convert.params_from_jax(dataclasses.replace(jp, smoothing=custom),
                                 decay=decay)
    assert tp.smoothing.decay is decay
    # So does an estimation system; without one, the carry refuses.
    pend = jmpc.make_pendulum(0.05)
    with_est = dataclasses.replace(jp, estimation_system=pend)
    with pytest.raises(ValueError, match="estimation_system"):
        convert.params_from_jax(with_est)
    est = tmpc.make_pendulum(0.05)
    tp = convert.params_from_jax(with_est, estimation_system=est)
    assert tp.estimation_system is est
    assert convert.params_from_jax(jp).estimation_system is None
