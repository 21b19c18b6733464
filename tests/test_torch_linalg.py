"""Port parity: irs_mpc_torch.ops.linalg against irs_mpc_tpu.ops.linalg.

Both sides run the same unrolled Gauss-Jordan elimination without pivoting
on the same numpy inputs.  Tolerance: rtol 1e-5 (float32 round-off of an
n <= 8 elimination on well-conditioned SPD matrices, summed in another
order), with atol 1e-6 for entries near zero."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from irs_mpc_tpu.ops import linalg as jlinalg  # noqa: E402
from irs_mpc_torch.ops import linalg as tlinalg  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
# Compiled once per shape: much cheaper in a test than op-by-op dispatch.
jax_solve_spd = jax.jit(jlinalg.solve_spd)
jax_inv_spd = jax.jit(jlinalg.inv_spd)


def _spd(rng, batch, n):
    M = rng.randn(*batch, n, n)
    return (M @ np.swapaxes(M, -1, -2) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_solve_spd_matches_jax(n, rhs):
    rng = np.random.RandomState(n)
    A = _spd(rng, (4,), n)
    b = rng.randn(4, n).astype(np.float32) if rhs == "vector" else \
        rng.randn(4, n, 3).astype(np.float32)
    want = np.asarray(jax_solve_spd(jnp.asarray(A), jnp.asarray(b)))
    got = tlinalg.solve_spd(torch.from_numpy(A), torch.from_numpy(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_inv_spd_matches_jax(n):
    rng = np.random.RandomState(10 + n)
    A = _spd(rng, (2, 3), n)
    want = np.asarray(jax_inv_spd(jnp.asarray(A)))
    got = tlinalg.inv_spd(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(A @ got, np.broadcast_to(np.eye(n), A.shape),
                               atol=1e-5)
