"""Port parity: the boxed trajectory QP (``ops/admm.py``, the plain version
of kernel K3) and the factored Riccati sweep against the JAX package.

The same numpy problems, the constructions of ``tests/test_pallas.py``, go
through both packages.

* ``riccati_factorize`` / ``riccati_linear`` against the JAX package's (rtol
  1e-4, atol 1e-5, as the plain Riccati loop in ``test_torch_lqr.py``), and
  the factored pass against the port's own full pass.
* ``solve_boxed_tvlqr`` on CPU tensors against the JAX package's scan
  backend over the five bound-kind combinations of the JAX package's
  whole-loop ADMM check, plus the planar-hand shape (T=30, n=7 + 4, u box,
  12 over-relaxed sweeps) and the carrots shape (T=10, n=45 + 5, m=5, u
  box, 20 sweeps): x, u, K at rtol/atol 1e-3 and the residuals at rtol
  1e-2, the tolerances of that check.  No kernel is launched.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_tpu.ops import admm as jadmm  # noqa: E402
from irs_mpc_tpu.ops import lqr as jlqr  # noqa: E402
from irs_mpc_torch.ops import admm as tadmm  # noqa: E402
from irs_mpc_torch.ops import cuda_admm, cuda_riccati  # noqa: E402
from irs_mpc_torch.ops import lqr as tlqr  # noqa: E402


def _arrays(T, n, m, seed, spread=0.3):
    """(A, B, c, Q, Qd, R, x0, xd) as float32 numpy, the construction of
    ``tests/test_pallas.py::_problem`` / ``_delta_u_problem``, with A = I +
    ``spread`` times a normal draw."""
    rng = np.random.RandomState(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    A = f(rng.randn(T, n, n) * spread + np.eye(n))
    B = f(rng.randn(T, n, m) * 0.5)
    c = f(rng.randn(T, n) * 0.1)
    Q = f(np.diag(rng.rand(n) + 0.5))
    R = f(np.diag(rng.rand(m) + 0.5))
    x0 = f(rng.randn(n))
    xd = f(rng.randn(T + 1, n) * 0.5)
    return A, B, c, Q, Q * 3, R, x0, xd


def _problems(T, n, m, seed, delta_u, spread=0.3):
    """The same problem as (JAX, torch) ``LqrProblem``s, and n_phys."""
    arrays = _arrays(T, n, m, seed, spread)
    if delta_u:
        idx = np.arange(m)
        return (jlqr.build_delta_u_problem(*map(jnp.asarray, arrays),
                                           jnp.asarray(idx, jnp.int32)),
                tlqr.build_delta_u_problem(*map(torch.from_numpy, arrays),
                                           torch.from_numpy(idx)), n)
    return (jlqr.build_tracking_problem(*map(jnp.asarray, arrays)),
            tlqr.build_tracking_problem(*map(torch.from_numpy, arrays)), n)


def _bounds(kinds, T, n_phys, m):
    """numpy (2, rows, dim) boxes of the widths of the JAX package's
    all-kinds check."""
    half = {"x": (T + 1, n_phys, 1.0), "u": (T, m, 0.3),
            "dx": (T, n_phys, 0.5), "du": (T, m, 0.2)}
    out = {}
    for kd in kinds:
        rows, dim, h = half[kd]
        out[kd] = np.stack([np.full((rows, dim), -h, np.float32),
                            np.full((rows, dim), h, np.float32)])
    return out


@pytest.mark.parametrize("delta_u", [False, True])
def test_factorize_and_linear_match_jax(delta_u):
    jprob, tprob, _ = _problems(12, 5, 3, 0, delta_u)
    jfac = jlqr.riccati_factorize(jprob)
    tfac = tlqr.riccati_factorize(tprob)
    for name in tlqr.RiccatiFactorization._fields:
        np.testing.assert_allclose(getattr(tfac, name).numpy(),
                                   np.asarray(getattr(jfac, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    jg = jlqr.riccati_linear(jprob, jfac)
    tg = tlqr.riccati_linear(tprob, tfac)
    for name in ("k", "p"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # The factored pass is the full pass split in two.
    full = tlqr.riccati_backward_plain(tprob)
    for name in ("K", "k", "P", "p"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   getattr(full, name).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


# (kinds, T, n, m, seed, Δu problem, rho, sweeps[, spread of A]): the five
# combinations of the JAX package's whole-loop check, the planar-hand and
# carrots trajectory QPs' shapes and settings, and no sweep at all (the
# unconstrained solution).  At carrots' width (n = 45 + 5) the default
# spread of A makes the dynamics so unstable that float32 fixes the
# solution only to ~4e-3 in either package, so that case takes
# near-identity dynamics, as a quasistatic model's are.
CASES = {
    "x": (("x",), 5, 4, 2, 13, False, 5.0, 4),
    "dx": (("dx",), 5, 4, 2, 13, False, 5.0, 4),
    "x+u": (("x", "u"), 5, 4, 2, 13, False, 5.0, 4),
    "du": (("du",), 5, 4, 2, 11, True, 5.0, 4),
    "u+du": (("u", "du"), 5, 4, 2, 11, True, 5.0, 4),
    "planar_hand_shape": (("u",), 30, 7, 4, 11, True, 1.0, 12),
    "carrots_shape": (("u",), 10, 45, 5, 3, True, 1.0, 20, 0.03),
    "no_sweep": (("u",), 5, 4, 2, 13, False, 5.0, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_boxed_admm_matches_jax(case):
    kinds, T, n, m, seed, delta_u, rho, iters, *spread = CASES[case]
    jprob, tprob, n_phys = _problems(T, n, m, seed, delta_u, *spread)
    n_aug = tprob.B.shape[1]
    b = _bounds(kinds, T, n_phys, m)
    kw = dict(n_phys=n_phys, rho=rho, iters=iters, over_relax=1.6)
    want = jadmm.solve_boxed_tvlqr(
        jprob, jadmm.BoxBounds(**{k: jnp.asarray(v) for k, v in b.items()}),
        idx_w=jnp.arange(n_phys, n_aug) if delta_u else None, **kw)
    before = (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES)
    got = tadmm.solve_boxed_tvlqr(
        tprob, tadmm.BoxBounds(**{k: torch.from_numpy(v)
                                  for k, v in b.items()}),
        idx_w=torch.arange(n_phys, n_aug) if delta_u else None, **kw)
    assert (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES) == before
    assert got.gains.P is not None          # the plain loop keeps P and p
    for name, g, w in (("u", got.u_trj, want.u_trj),
                       ("x", got.x_trj, want.x_trj),
                       ("K", got.gains.K, want.gains.K)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3, err_msg=name)
    for name in ("r_primal", "r_dual"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-2,
                                   atol=1e-3, err_msg=name)
    # The boxes bind: the unconstrained solution leaves them.
    free_x, free_u, _ = tlqr.lqr_solve(tprob)
    s = tadmm._stage_values(tprob, free_x, free_u, n_phys,
                            torch.arange(n_phys, n_aug) if delta_u else None)
    assert any(float(getattr(s, k).abs().max()) > b[k][1].max()
               for k in kinds)


def test_all_none_bounds_give_the_unconstrained_solve():
    jprob, tprob, n = _problems(6, 3, 2, 5, False)
    sol = tadmm.solve_boxed_tvlqr(tprob, tadmm.BoxBounds(), n_phys=n)
    x, u, gains = tlqr.lqr_solve(tprob)
    np.testing.assert_array_equal(sol.u_trj.numpy(), u.numpy())
    np.testing.assert_array_equal(sol.gains.K.numpy(), gains.K.numpy())
    assert float(sol.r_primal) == 0.0 and float(sol.r_dual) == 0.0
    want = jadmm.solve_boxed_tvlqr(jprob, jadmm.BoxBounds(), n_phys=n)
    np.testing.assert_allclose(sol.x_trj.numpy(), np.asarray(want.x_trj),
                               rtol=1e-4, atol=1e-5)
