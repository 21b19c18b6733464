"""Port parity: irs_mpc_torch.ops.lqr against irs_mpc_tpu.ops.lqr.

The same numpy problems go through the problem builders, the plain Riccati
loop (K, k, P, p) and the linear rollout of both packages (rtol 1e-4,
atol 1e-5: float32 round-off through a T=12 recursion), and the port's K, k
are held against the JAX package's Pallas Riccati kernel run in interpret
mode, at the tolerance of that kernel's own test (``tests/test_pallas.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_tpu.ops import lqr as jlqr  # noqa: E402
from irs_mpc_tpu.ops.pallas_riccati import \
    riccati_backward_pallas  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.ops import cuda_riccati  # noqa: E402
from irs_mpc_torch.ops import lqr as tlqr  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _inputs(T, n, m, seed):
    """(A, B, c, Q, Qd, R, x0, xd) as float32 numpy, the construction of
    ``tests/test_pallas.py::_problem``."""
    rng = np.random.RandomState(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    A = f(rng.randn(T, n, n) * 0.3 + np.eye(n))
    B = f(rng.randn(T, n, m) * 0.5)
    c = f(rng.randn(T, n) * 0.1)
    Q = f(np.diag(rng.rand(n) + 0.5))
    R = f(np.diag(rng.rand(m) + 0.5))
    x0 = f(rng.randn(n))
    xd = f(rng.randn(T + 1, n) * 0.5)
    return A, B, c, Q, Q * 3, R, x0, xd


def _build(kind, pkg, arrays, idx):
    """Build the same problem with the JAX (pkg=jlqr) or torch builder."""
    conv = jnp.asarray if pkg is jlqr else torch.from_numpy
    args = [conv(a) for a in arrays]
    if kind == "tracking":
        return pkg.build_tracking_problem(*args)
    if kind == "prev_u":
        return pkg.build_prev_u_tracking_problem(*args)
    ind = jnp.asarray(idx) if pkg is jlqr else torch.from_numpy(idx)
    return pkg.build_delta_u_problem(*args, ind)


CASES = {
    # (T, n, m, seed, builder, indices_u_into_x)
    "tracking": (12, 5, 3, 0, "tracking", None),
    "delta_u": (8, 4, 2, 3, "delta_u", np.array([0, 2])),
    "prev_u": (10, 3, 2, 5, "prev_u", None),
}


def _both(case):
    T, n, m, seed, kind, idx = CASES[case]
    arrays = _inputs(T, n, m, seed)
    return _build(kind, jlqr, arrays, idx), _build(kind, tlqr, arrays, idx)


@pytest.mark.parametrize("case", sorted(CASES))
def test_builders_match_jax(case):
    jprob, tprob = _both(case)
    for name, a, b in zip(jlqr.LqrProblem._fields, jprob, tprob):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_riccati_and_rollout_match_jax(case):
    jprob, tprob = _both(case)
    jg = jlqr.riccati_backward(jprob)
    tg = tlqr.riccati_backward_plain(tprob)
    for name in ("K", "k", "P", "p"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    jx, ju = jlqr.lqr_rollout_linear(jprob, jg)
    tx, tu = tlqr.lqr_rollout_linear(tprob, tg)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lqr_solve_matches_jax(case):
    """``lqr_solve`` on CPU tensors (the plain version of K1 with its plan:
    ``riccati_backward_plain`` and ``lqr_rollout_linear``) against the JAX
    package's ``lqr_solve``: x, u, K and k at the rtol/atol of the plain
    loop's parity above."""
    jprob, tprob = _both(case)
    jx, ju, jg = jlqr.lqr_solve(jprob)
    tx, tu, tg = tlqr.lqr_solve(tprob)
    for name, got, want in (("x", tx, jx), ("u", tu, ju), ("K", tg.K, jg.K),
                            ("k", tg.k, jg.k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["tracking", "delta_u"])
def test_gains_match_pallas_kernel_in_interpret_mode(case):
    jprob, tprob = _both(case)
    if jax.devices()[0].platform != "tpu":
        with pltpu.force_tpu_interpret_mode():
            jg = riccati_backward_pallas(jprob)
    else:
        jg = riccati_backward_pallas(jprob)
    tg = tlqr.riccati_backward(tprob)
    np.testing.assert_allclose(tg.K.numpy(), np.asarray(jg.K),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tg.k.numpy(), np.asarray(jg.k),
                               rtol=1e-2, atol=1e-2)


def test_cpu_tensors_never_reach_the_kernel():
    _, tprob = _both("tracking")
    before = cuda_riccati.LAUNCHES
    gains = tlqr.riccati_backward(tprob)
    x, u, solved = tlqr.lqr_solve(tprob)
    assert cuda_riccati.LAUNCHES == before
    ref = tlqr.riccati_backward_plain(tprob)
    for a, b in zip(gains, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(solved.K.numpy(), ref.K.numpy())
    assert x.shape == (13, 5) and u.shape == (12, 3)


def test_riccati_backend_other_than_auto_raises():
    """"assoc" solves (the associative scan, ``tests/test_torch_assoc.py``)
    on either entry point; a backend the port does not have, such as the
    JAX package's "pallas", raises ValueError."""
    _, tprob = _both("tracking")
    ref = tlqr.riccati_backward_plain(tprob)
    before = cuda_riccati.LAUNCHES
    for fn in (tlqr.riccati_backward, tlqr.lqr_solve):
        out = fn(tprob, backend="assoc")
        gains = out if fn is tlqr.riccati_backward else out[2]
        assert gains.P.shape == ref.P.shape
        np.testing.assert_allclose(gains.K.numpy(), ref.K.numpy(),
                                   rtol=5e-3, atol=5e-3)
        with pytest.raises(ValueError):
            fn(tprob, backend="pallas")
    assert cuda_riccati.LAUNCHES == before


def test_problem_from_numpy_and_split_augmented():
    jprob, tprob = _both("delta_u")
    prob = convert.problem_from_numpy(*jprob)
    for a, b in zip(prob, tprob):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    x_aug = torch.arange(12.).reshape(3, 4)
    assert tlqr.split_augmented(x_aug, 2).tolist() == \
        np.asarray(jlqr.split_augmented(jnp.asarray(x_aug.numpy()),
                                        2)).tolist()
