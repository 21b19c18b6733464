"""Port parity: the analytic models of irs_mpc_torch (bicycle, quadrotor,
three carts) against irs_mpc_tpu's, on the CPU.

* ``step`` on one state, ``step_batch``, ``jacobian_xu`` (batched) and a
  rollout, on the same numpy draws: atol 1e-6 (the quadrotor at rtol 1e-5
  and atol 1e-6: its rates reach ~10, and the two packages order the
  float32 sums of its rotation and cross products differently).
* The three carts' sample projection, batched over knots in the port and
  per knot in the JAX package: atol 1e-6.  States are drawn around the
  contact set so that every collision case (all three, 1-2, 2-3, none)
  occurs.
* ``convert.system_from_jax`` rebuilds each model from the JAX one.
* The iRS examples' initial costs (deterministic rollouts) equal the JAX
  package's goldens at rtol 1e-5, and ``chip_smoke``'s analytic
  configurations are the JAX examples', carried across.
"""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import chip_smoke  # noqa: E402
import irs_mpc_tpu as jmpc  # noqa: E402
import irs_mpc_torch as tmpc  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402

# (name, factory kwargs, state draw scale, input draw scale, rtol)
MODELS = {
    "bicycle": (dict(h=0.1), 1.0, 1.0, 0.0),
    "quadrotor": (dict(h=0.05), 0.5, 2.0, 1e-5),
    "three_cart": (dict(h=0.05, d=0.2), 1.0, 3.0, 0.0),
}


def _pair(name):
    kw = MODELS[name][0]
    return (getattr(jmpc, f"make_{name}")(**kw),
            getattr(tmpc, f"make_{name}")(**kw))


def _draws(name, B=32, seed=0):
    """States and inputs (numpy float32) for ``name``; for the carts the
    positions sit around the contact distance d = 0.2."""
    js, _ = _pair(name)
    _, sx, su, _ = MODELS[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(B, js.dim_x) * sx
    u = rng.randn(B, js.dim_u) * su
    if name == "three_cart":
        x[:, 0] = rng.randn(B) * 0.05
        x[:, 1] = x[:, 0] + 0.2 + rng.randn(B) * 0.08
        x[:, 2] = x[:, 1] + 0.2 + rng.randn(B) * 0.08
    return x.astype(np.float32), u.astype(np.float32)


def _close(got, want, name):
    rtol = MODELS[name][3]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(MODELS))
def test_step_and_batch_match_jax(name):
    js, ts = _pair(name)
    x, u = _draws(name)
    want = np.asarray(js.step_batch(jnp.asarray(x), jnp.asarray(u)))
    got = ts.step_batch(torch.from_numpy(x), torch.from_numpy(u))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, name)
    one = ts.step(torch.from_numpy(x[0]), torch.from_numpy(u[0]))
    assert tuple(one.shape) == (ts.dim_x,)
    _close(one.numpy(), np.asarray(js.step(jnp.asarray(x[0]),
                                           jnp.asarray(u[0]))), name)


@pytest.mark.parametrize("name", list(MODELS))
def test_jacobian_matches_jax(name):
    js, ts = _pair(name)
    x, u = _draws(name, B=8, seed=1)
    want = np.asarray(js.jacobian_xu_batch(jnp.asarray(x), jnp.asarray(u)))
    got = ts.jacobian_xu_batch(torch.from_numpy(x), torch.from_numpy(u))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (8, ts.dim_x, ts.dim_x + ts.dim_u)
    _close(got.numpy(), want, name)


@pytest.mark.parametrize("name", list(MODELS))
def test_rollout_matches_jax(name):
    js, ts = _pair(name)
    x, u = _draws(name, B=12, seed=2)
    u_trj = 0.3 * u
    if name == "quadrotor":
        # Near hover (u = 2.0), as the example flies: from the random
        # attitudes and thrusts of the step test the flight is unstable
        # and 12 knots grow the packages' one-ulp step differences past
        # rtol 1e-5.
        x[0], u_trj = 0.1 * x[0], 2.0 + 0.1 * u
    want = np.asarray(js.rollout(jnp.asarray(x[0]), jnp.asarray(u_trj)))
    got = ts.rollout(torch.from_numpy(x[0]), torch.from_numpy(u_trj))
    assert tuple(got.shape) == (13, ts.dim_x)
    _close(got.numpy(), want, name)
    # A batch of input trajectories rolls as independent chains.
    batch = ts.rollout(torch.from_numpy(x[0]),
                       torch.from_numpy(np.stack([u_trj, -u_trj])))
    np.testing.assert_allclose(batch[0].numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_three_cart_projection_matches_jax():
    js, ts = _pair("three_cart")
    T, S = 5, 40
    rng = np.random.RandomState(3)
    x = np.zeros((T, 6), np.float32)
    x[:, :3] = [0.0, 0.2, 0.4]
    u = rng.randn(T, 2).astype(np.float32)
    dx = (rng.randn(T, S, 6) * 0.1).astype(np.float32)
    du = (rng.randn(T, S, 2) * 0.5).astype(np.float32)
    got_x, got_u = ts.projection(*map(torch.from_numpy, (x, dx, u, du)))
    for t in range(T):
        wx, wu = js.projection(*map(jnp.asarray, (x[t], dx[t], u[t], du[t])))
        np.testing.assert_allclose(got_x[t].numpy(), np.asarray(wx),
                                   atol=1e-6)
        np.testing.assert_allclose(got_u[t].numpy(), np.asarray(wu),
                                   atol=1e-6)
    # Every collision case occurred among the samples.
    gaps = np.diff(x[:, None, :3] + dx[..., :3], axis=-1) < 0.2
    for case in ([True, True], [True, False], [False, True],
                 [False, False]):
        assert (gaps == case).all(-1).any(), case


@pytest.mark.parametrize("name", ["pendulum"] + list(MODELS))
def test_system_from_jax(name):
    kw = MODELS[name][0] if name in MODELS else dict(h=0.07)
    if name == "three_cart":
        kw = dict(h=0.05, d=0.35)
    js = getattr(jmpc, f"make_{name}")(**kw)
    ts = convert.system_from_jax(js)
    assert (ts.name, ts.dim_x, ts.dim_u, ts.h) == (js.name, js.dim_x,
                                                  js.dim_u, js.h)
    x, u = (np.full(js.dim_x, 0.1, np.float32),
            np.full(js.dim_u, 0.2, np.float32))
    x[:3] = x[:3] * np.arange(3) if name == "three_cart" else x[:3]
    np.testing.assert_allclose(
        ts.step(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
        np.asarray(js.step(jnp.asarray(x), jnp.asarray(u))), rtol=1e-5,
        atol=1e-6)
    with pytest.raises(ValueError, match="no analytic factory"):
        convert.system_from_jax(dataclasses.replace(js, name="carrots"))


@pytest.mark.parametrize("name, initial", [
    ("quadrotor", chip_smoke.QUAD_INITIAL),
    ("three_cart", chip_smoke.CART_INITIAL)])
def test_example_initial_cost_and_configuration(name, initial):
    """The smoke's configuration is the JAX example's (the same params,
    smoothing schedule and model), and its initial cost the golden."""
    import importlib
    ex = importlib.import_module(name)
    jp = ex.build_params("zero_order") if name == "quadrotor" \
        else ex.build_params()
    smoke = getattr(chip_smoke, f"{name}_solver")("cpu")
    tp = smoke.params
    for f in ("Q", "Qd", "R", "x0", "xd_trj", "u_trj_init", "u_bounds_abs",
              "gradient_mode"):
        a, b = getattr(jp, f), getattr(tp, f)
        if a is None or isinstance(a, str):
            assert a == b, f
        else:
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32),
                                          err_msg=f)
    for f in ("num_samples", "std_x", "std_u"):
        assert np.all(np.asarray(getattr(jp.smoothing, f))
                      == np.asarray(getattr(tp.smoothing, f))), f
    for it in (1, 3):
        assert float(tp.smoothing.decay(torch.tensor(float(it)))) == \
            pytest.approx(float(jp.smoothing.decay(jnp.asarray(float(it)))),
                          rel=1e-6)
    assert smoke.system.name == name
    np.testing.assert_allclose(smoke.cost_lst[0], initial, rtol=1e-5)
