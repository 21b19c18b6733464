"""Port parity: the pendulum of irs_mpc_torch against irs_mpc_tpu's.

Same numpy inputs through ``step``, ``step_batch``, ``jacobian_xu(_batch)``
and ``rollout``; atol 1e-6 (float32 round-off of a few flops per step, and
of sin in two libraries)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_tpu import make_pendulum as jax_pendulum  # noqa: E402
from irs_mpc_torch import make_pendulum as torch_pendulum  # noqa: E402

ATOL = 1e-6
B = 16


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(B, 2).astype(np.float32) * 2.0
    u = rng.randn(B, 1).astype(np.float32)
    return x, u


@pytest.fixture(scope="module")
def systems():
    return jax_pendulum(0.05), torch_pendulum(0.05)


def test_step_matches_jax(inputs, systems):
    (x, u), (js, ts) = inputs, systems
    for i in range(B):
        want = np.asarray(js.step(jnp.asarray(x[i]), jnp.asarray(u[i])))
        got = ts.step(torch.from_numpy(x[i]), torch.from_numpy(u[i]))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_step_batch_matches_jax_and_unbatched(inputs, systems):
    (x, u), (js, ts) = inputs, systems
    want = np.asarray(js.step_batch(jnp.asarray(x), jnp.asarray(u)))
    got = ts.step_batch(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    one = torch.stack([ts.step(torch.from_numpy(x[i]),
                               torch.from_numpy(u[i])) for i in range(B)])
    np.testing.assert_array_equal(got.numpy(), one.numpy())


def test_jacobian_matches_jax_and_unbatched(inputs, systems):
    (x, u), (js, ts) = inputs, systems
    want = np.asarray(js.jacobian_xu_batch(jnp.asarray(x), jnp.asarray(u)))
    got = ts.jacobian_xu_batch(torch.from_numpy(x), torch.from_numpy(u))
    assert got.shape == (B, 2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    one = torch.stack([ts.jacobian_xu(torch.from_numpy(x[i]),
                                      torch.from_numpy(u[i]))
                       for i in range(B)])
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL, rtol=0)


def test_rollout_matches_jax(systems):
    js, ts = systems
    rng = np.random.RandomState(1)
    x0 = rng.randn(2).astype(np.float32)
    u = rng.randn(40, 1).astype(np.float32)
    want = np.asarray(js.rollout(jnp.asarray(x0), jnp.asarray(u)))
    got = ts.rollout(torch.from_numpy(x0), torch.from_numpy(u))
    assert got.shape == (41, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
