"""Port parity: the associative-scan Riccati pass of irs_mpc_torch
(``lqr.riccati_backward_assoc``) against the port's sequential pass and
against the JAX package's ``riccati_backward_assoc``, on the CPU.

* K, k and P on tracking and Δu problems (the cross term N) at T = 10, 13
  and 16 (T + 1 = 11, 14, 17 elements: never a power of two), at the
  tolerances of the JAX package's own assoc tests
  (``tests/test_lqr.py:94-119``: 5e-3 tracking, 1e-2 Δu).
* ``lqr_solve(parallel=True)`` and backend "assoc" run the scan and the
  linear plan on the CPU with no kernel launch.
* The pendulum solver with ``parallel_riccati`` against the sequential one,
  within 1e-3 after 4 iterations (``tests/test_irs_mpc.py:40-46``).
* The boxed ADMM with ``parallel=True`` (a full assoc solve of the
  penalised problem every sweep) against the JAX package's assoc-backed
  ADMM, the case of ``tests/test_admm.py:331-342``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import irs_mpc_torch as tmpc  # noqa: E402
from irs_mpc_tpu.ops import admm as jadmm  # noqa: E402
from irs_mpc_tpu.ops import lqr as jlqr  # noqa: E402
from irs_mpc_torch.ops import admm as tadmm  # noqa: E402
from irs_mpc_torch.ops import cuda_admm, cuda_riccati  # noqa: E402
from irs_mpc_torch.ops import lqr as tlqr  # noqa: E402

TOL = {"tracking": 5e-3, "delta_u": 1e-2}


def _random_problem(T, n, m, seed):
    """The construction of ``tests/test_lqr.py::_random_problem``, float32
    numpy."""
    rng = np.random.RandomState(seed)
    A = rng.randn(T, n, n) * 0.4 + np.eye(n)
    B = rng.randn(T, n, m) * 0.5
    c = rng.randn(T, n) * 0.1
    Qh = rng.randn(n, n)
    Q = Qh @ Qh.T * 0.1 + np.eye(n)
    Rh = rng.randn(m, m)
    R = Rh @ Rh.T * 0.1 + np.eye(m)
    x0 = rng.randn(n)
    xd = rng.randn(T + 1, n) * 0.5
    return tuple(np.asarray(a, np.float32)
                 for a in (A, B, c, Q, Q * 3.0, R, x0, xd))


def _problems(kind, T, seed=2):
    n, m = (4, 2) if kind == "tracking" else (3, 2)
    arrays = _random_problem(T, n, m, seed)
    if kind == "tracking":
        return (jlqr.build_tracking_problem(*map(jnp.asarray, arrays)),
                tlqr.build_tracking_problem(*map(torch.from_numpy, arrays)))
    idx = np.array([0, 2])
    return (jlqr.build_delta_u_problem(*map(jnp.asarray, arrays),
                                       jnp.asarray(idx)),
            tlqr.build_delta_u_problem(*map(torch.from_numpy, arrays),
                                       torch.from_numpy(idx)))


@pytest.mark.parametrize("T", [10, 13, 16])
@pytest.mark.parametrize("kind", ["tracking", "delta_u"])
def test_assoc_matches_sequential_and_jax(kind, T):
    jprob, tprob = _problems(kind, T)
    got = tlqr.riccati_backward_assoc(tprob)
    seq = tlqr.riccati_backward_plain(tprob)
    want = jax.jit(jlqr.riccati_backward_assoc)(jprob)
    tol = TOL[kind]
    assert got.P.shape == (T + 1,) + seq.P.shape[1:]
    assert got.p.shape == seq.p.shape
    for name in ("K", "k", "P"):
        g = getattr(got, name).numpy()
        np.testing.assert_allclose(g, getattr(seq, name).numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{name} vs sequential")
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)),
                                   rtol=tol, atol=tol,
                                   err_msg=f"{name} vs JAX")


def test_suffix_scan_composes_every_suffix():
    """Element t of the scan is the left-to-right composition of elements
    t..L-1, for an L (11) that is not a power of two."""
    rng = np.random.RandomState(0)
    L, n = 11, 3

    def rand_elems(k):
        def sym(a):
            return a @ a.transpose(0, 2, 1) * 0.1

        f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
        return tlqr._AssocElem(
            F=f(np.eye(n) + 0.1 * rng.randn(k, n, n)),
            b=f(rng.randn(k, n) * 0.1), C=f(sym(rng.randn(k, n, n))),
            eta=f(rng.randn(k, n) * 0.1), J=f(sym(rng.randn(k, n, n))))

    elems = rand_elems(L)
    got = tlqr._suffix_scan(elems)
    for t in (0, 4, L - 1):
        acc = tlqr._AssocElem(*(a[L - 1] for a in elems))
        for s in range(L - 2, t - 1, -1):
            acc = tlqr._assoc_combine(
                tlqr._AssocElem(*(a[s] for a in elems)), acc)
        for a, b in zip(got, acc):
            np.testing.assert_allclose(a[t].numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)


def test_parallel_lqr_solve_runs_the_scan_on_the_cpu():
    _, tprob = _problems("delta_u", 13)
    before = cuda_riccati.LAUNCHES
    x, u, gains = tlqr.lqr_solve(tprob, parallel=True)
    gains_b = tlqr.riccati_backward(tprob, backend="assoc")
    assert cuda_riccati.LAUNCHES == before
    for a, b in zip(gains, gains_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    xs, us = tlqr.lqr_rollout_linear(tprob, gains)
    np.testing.assert_array_equal(x.numpy(), xs.numpy())
    np.testing.assert_array_equal(u.numpy(), us.numpy())
    xq, uq, _ = tlqr.lqr_solve(tprob)
    np.testing.assert_allclose(u.numpy(), uq.numpy(), atol=1e-2)


def _pendulum(parallel):
    T = 200
    return tmpc.IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode="exact",
        parallel_riccati=parallel)


def test_pendulum_parallel_riccati_matches():
    s1 = tmpc.IrsMpc(tmpc.make_pendulum(0.05), _pendulum(False),
                     device="cpu")
    s2 = tmpc.IrsMpc(tmpc.make_pendulum(0.05), _pendulum(True),
                     device="cpu")
    s1.iterate(4, verbose=False)
    s2.iterate(4, verbose=False)
    assert abs(s1.cost - s2.cost) / s1.cost < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_parallel_admm_matches_jax_assoc_admm(seed):
    arrays = _random_problem(6, 3, 2, seed)
    jprob = jlqr.build_tracking_problem(*map(jnp.asarray, arrays))
    tprob = tlqr.build_tracking_problem(*map(torch.from_numpy, arrays))
    T, n, m = tprob.B.shape
    box = np.stack([np.full((T, m), -0.3), np.full((T, m), 0.3)]).astype(
        np.float32)
    want = jax.jit(lambda p, b: jadmm.solve_boxed_tvlqr(
        p, jadmm.BoxBounds(u=b), n_phys=n, rho=5.0, iters=120,
        backend="assoc"))(jprob, jnp.asarray(box))
    before = (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES)
    got = tadmm.solve_boxed_tvlqr(
        tprob, tadmm.BoxBounds(u=torch.from_numpy(box)), n_phys=n, rho=5.0,
        iters=120, parallel=True)
    assert (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES) == before
    assert got.gains.P is not None
    np.testing.assert_allclose(got.u_trj.numpy(), np.asarray(want.u_trj),
                               atol=2e-3)
    np.testing.assert_allclose(got.x_trj.numpy(), np.asarray(want.x_trj),
                               atol=2e-3)
    assert float(got.r_primal) < 1e-3
    # ... and the factored loop (K3's plain version) on the same problem.
    fast = tadmm.solve_boxed_tvlqr(
        tprob, tadmm.BoxBounds(u=torch.from_numpy(box)), n_phys=n, rho=5.0,
        iters=120)
    assert float((fast.u_trj - got.u_trj).abs().max()) < 2e-3
