"""Port parity: irs_mpc_torch.ops.estimators against irs_mpc_tpu's.

PyTorch's random stream differs from JAX's, so the test draws the
perturbations exactly as the JAX estimator does (one key per knot) and
injects them into the port through ``perturbations=``.  A, B and c are then
compared for every gradient mode on the pendulum at T=10, S=64 with rtol
1e-4 / atol 1e-4: the float32 Gram sums over 64 samples are taken in
another order in the two packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_tpu import make_pendulum as jax_pendulum  # noqa: E402
from irs_mpc_tpu.ops import estimators as jest  # noqa: E402
from irs_mpc_torch import make_pendulum as torch_pendulum  # noqa: E402
from irs_mpc_torch.ops import estimators as test_  # noqa: E402

T, S, IT = 10, 64, 2
# The JAX estimator compiled once per (system, mode, config): much cheaper
# in a test than op-by-op dispatch.
jax_estimate = jax.jit(jest.estimate_tv_matrices, static_argnums=(0, 1, 6))
TOL = dict(rtol=1e-4, atol=1e-4)


def _nominal(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(T + 1, 2).astype(np.float32)
    u = rng.randn(T, 1).astype(np.float32)
    return x, u


def _jax_draws(cfg, key):
    """The scaled perturbations the JAX estimator draws from ``key``."""
    sx, su = cfg.stds(jnp.asarray(IT, jnp.float32), 2, 1)
    keys = jax.random.split(key, T)
    dx, du = jax.vmap(
        lambda k: jest._sample_perturbations(k, sx, su, S))(keys)
    return torch.from_numpy(np.array(dx)), torch.from_numpy(np.array(du))


def _clip_projection_jax(x, dx, u, du):
    return x + jnp.clip(dx, -0.5, 0.5), u + du


def _clip_projection_torch(x, dx, u, du):
    return x[:, None] + dx.clamp(-0.5, 0.5), u[:, None] + du


CASES = [
    # (id, mode, zero_order_B_A_source, with a sample projection)
    ("exact", "exact", "exact", False),
    ("first_order", "first_order", "exact", False),
    ("zero_order", "zero_order", "exact", False),
    ("zero_order_B", "zero_order_B", "exact", False),
    ("zero_order_B-first_order_A", "zero_order_B", "first_order", False),
    ("zero_order_AB", "zero_order_AB", "exact", False),
    ("zero_order-projected", "zero_order", "exact", True),
    ("first_order-projected", "first_order", "exact", True),
]


@pytest.mark.parametrize("mode, a_source, projected",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_estimates_match_jax_with_injected_samples(mode, a_source, projected):
    x, u = _nominal()
    js, ts = jax_pendulum(0.05), torch_pendulum(0.05)
    if projected:
        js = dataclasses.replace(js, projection=_clip_projection_jax)
        ts = dataclasses.replace(ts, projection=_clip_projection_torch)
    kw = dict(num_samples=S, std_x=np.array([0.8, 1.2]), std_u=1.0,
              damp=0.05, zero_order_B_A_source=a_source)
    jcfg = jest.SmoothingConfig(**kw)
    tcfg = test_.SmoothingConfig(**kw)
    key = jax.random.PRNGKey(7)

    want = jax_estimate(js, mode, jnp.asarray(x), jnp.asarray(u), key,
                        jnp.asarray(IT, jnp.float32), jcfg)
    got = test_.estimate_tv_matrices(
        ts, mode, torch.from_numpy(x), torch.from_numpy(u), None, IT, tcfg,
        perturbations=_jax_draws(jcfg, key))
    for name in ("A", "B", "c"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("it", [1, 2, 3, 7])
def test_variance_decay_matches_jax(it):
    kw = dict(std_x=np.array([0.8, 1.2]), std_u=0.5)
    jsx, jsu = jest.SmoothingConfig(**kw).stds(jnp.asarray(it, jnp.float32),
                                               2, 1)
    tsx, tsu = test_.SmoothingConfig(**kw).stds(it, 2, 1)
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tsu.numpy(), np.asarray(jsu))
    tsx, _ = test_.SmoothingConfig(decay_std_x=False, **kw).stds(it, 2, 1)
    np.testing.assert_array_equal(tsx.numpy(),
                                  np.array([0.8, 1.2], np.float32))


def test_own_draws_have_the_configured_spread():
    x, u = _nominal()
    cfg = test_.SmoothingConfig(num_samples=4000, std_x=np.array([0.5, 2.0]),
                                std_u=1.5)
    sx, su = cfg.stds(4, 2, 1)
    gen = torch.Generator().manual_seed(0)
    dx, du = test_.draw_perturbations(gen, sx, su, 3, cfg.num_samples)
    assert dx.shape == (3, 4000, 2) and du.shape == (3, 4000, 1)
    np.testing.assert_allclose(dx.std(dim=(0, 1)).numpy(), [0.25, 1.0],
                               rtol=0.05)
    np.testing.assert_allclose(du.std().item(), 0.75, rtol=0.05)


def test_zero_order_converges_to_exact_jacobian():
    """With small perturbations the fit recovers the exact Jacobian."""
    x, u = _nominal()
    ts = torch_pendulum(0.05)
    cfg = test_.SmoothingConfig(num_samples=500, std_x=1e-2, std_u=1e-2)
    gen = torch.Generator().manual_seed(3)
    got = test_.estimate_tv_matrices(ts, "zero_order", torch.from_numpy(x),
                                     torch.from_numpy(u), gen, 1, cfg)
    exact = test_.estimate_tv_matrices(ts, "exact", torch.from_numpy(x),
                                       torch.from_numpy(u), None, 1, cfg)
    np.testing.assert_allclose(got.A.numpy(), exact.A.numpy(), atol=2e-3)
    np.testing.assert_allclose(got.B.numpy(), exact.B.numpy(), atol=2e-3)


def test_fit_from_moments_matches_jax():
    rng = np.random.RandomState(4)
    Sm = rng.randn(5, 40, 3).astype(np.float32)
    D = rng.randn(5, 40, 2).astype(np.float32)
    G = np.swapaxes(Sm, 1, 2) @ Sm
    M = np.swapaxes(Sm, 1, 2) @ D
    want = jax.jit(jax.vmap(
        lambda g, m: jest.fit_from_moments(g, m, damp=0.1)))(
            jnp.asarray(G), jnp.asarray(M))
    got = test_.fit_from_moments(torch.from_numpy(G), torch.from_numpy(M),
                                 damp=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decouple_AB_matches_jax():
    x, u = _nominal(1)
    js, ts = jax_pendulum(0.05), torch_pendulum(0.05)
    rng = np.random.RandomState(2)
    A = rng.randn(T, 2, 2).astype(np.float32)
    B = rng.randn(T, 2, 1).astype(np.float32)
    c = rng.randn(T, 2).astype(np.float32)
    want = jax.jit(jest.decouple_AB, static_argnums=(4,))(
        jest.TvLinearization(*map(jnp.asarray, (A, B, c))),
        jnp.asarray([1]), jnp.asarray(x), jnp.asarray(u), js)
    tv = test_.TvLinearization(*map(torch.from_numpy, (A, B, c)))
    got = test_.decouple_AB(tv, torch.tensor([1]), torch.from_numpy(x),
                            torch.from_numpy(u), ts)
    for name in ("A", "B", "c"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, rtol=1e-5, atol=1e-6)
    # The input is left as it was.
    np.testing.assert_array_equal(tv.B.numpy(), B)
