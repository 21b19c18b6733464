"""Port parity: the batched contact QP (the plain version of kernel K2)
against the JAX package's ``models/contact/qp.py``.

The same 64 planar-hand contact QPs, drawn with numpy around the resting
configuration at the estimation sweep's spread, go through
``jax.vmap(qp._pdip_solve)`` and the port's batched ``_pdip_solve``
(``cuda_qp.solve_qp_batched`` on CPU tensors): cold at 30 iterations,
warm from a previous (x, lam) at 10, and with the duals returned.  The
primal agrees to atol 1e-5 (float32 round-off through the same unpivoted
eliminations; the solutions are ~1e-2).  Duals of active rows sit near the
slack floor and differ in their last digits, so they are compared where
they are large (rtol 1e-3) and by sign.

``solve_qp``'s forward-mode derivative, the implicit-function JVP, is held
against ``jax.jvp`` of the JAX ``custom_jvp``, against the port's own
float64 evaluation and against central finite differences (the JAX
package's own check), alone and under ``torch.func.vmap``.  Where a row is
active its KKT matrix has a condition number of 1e5 to 1e6 at 40
iterations, and the float32 JVP is determined only to cond * 2^-23; the
tolerance there is that resolution, and 1e-6 where no row is active.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_tpu.models.contact import qp as jqp  # noqa: E402
from irs_mpc_tpu.models.contact.systems import \
    make_planar_hand as jmake  # noqa: E402
from irs_mpc_torch.models.contact import cuda_qp  # noqa: E402
from irs_mpc_torch.models.contact import qp as tqp  # noqa: E402

B = 64


def _qps(seed=0):
    """(P, q, C, d) as numpy f32: planar-hand contact QPs around q0."""
    model = jmake()
    q0 = np.array([0.0, 0.35, 0.0, -np.pi / 4, -np.pi / 4, np.pi / 4,
                   np.pi / 4], np.float32)
    rng = np.random.RandomState(seed)
    x = (q0 + 1e-3 * rng.randn(B, 7)).astype(np.float32)
    u = (q0[3:] + 0.3 * rng.randn(B, 4)).astype(np.float32)
    P, q = jax.vmap(model._hessian_and_bias)(x, u)
    C, d = jax.vmap(model._constraint_rows)(x)
    return tuple(np.asarray(a) for a in (P, q, C, d))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_pdip(P, q, C, d, iters, init=None):
    fn = jax.jit(jax.vmap(lambda *a: jqp._pdip_solve(*a[:4], iters,
                                                     init=a[4:] or None)))
    args = (P, q, C, d) + (tuple(init) if init is not None else ())
    return tuple(np.asarray(a) for a in fn(*args))


def _check_duals(got, want):
    big = want > 1e-2
    assert big.any()
    np.testing.assert_allclose(got[big], want[big], rtol=1e-3)
    assert (got >= 0).all() and np.isfinite(got).all()


def test_cold_pdip_matches_jax():
    P, q, C, d = _qps()
    x, s, lam = _jax_pdip(P, q, C, d, 30)
    got = cuda_qp.solve_qp_batched(_t(P), _t(q), _t(C), _t(d), 30)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-5)
    # The cold 30-iteration solves are close to converged ones.
    conv = cuda_qp.solve_qp_batched(_t(P), _t(q), _t(C), _t(d), 120)
    assert (got - conv).abs().max().item() < 1e-3


def test_cold_pdip_with_duals_matches_jax():
    P, q, C, d = _qps(seed=1)
    x, _, lam = _jax_pdip(P, q, C, d, 15)
    got_x, got_lam = cuda_qp.solve_qp_batched(_t(P), _t(q), _t(C), _t(d),
                                              15, want_lam=True)
    np.testing.assert_allclose(got_x.numpy(), x, atol=1e-5)
    _check_duals(got_lam.numpy(), lam)


def test_warm_pdip_matches_jax():
    P, q, C, d = _qps(seed=2)
    rng = np.random.RandomState(3)
    x0 = (rng.randn(B, 7) * 0.01).astype(np.float32)
    lam0 = (np.abs(rng.randn(B, C.shape[1])) + 0.5).astype(np.float32)
    # One lane starts from a non-finite primal and dual: the warm start
    # zeroes the primal and resets the dual, as the JAX package does.
    x0[5, 2] = np.nan
    lam0[5, 1] = np.inf
    x, _, lam = _jax_pdip(P, q, C, d, 10, init=(x0, lam0))
    got_x, got_lam = cuda_qp.solve_qp_batched(
        _t(P), _t(q), _t(C), _t(d), 10, init=(_t(x0), _t(lam0)),
        want_lam=True)
    np.testing.assert_allclose(got_x.numpy(), x, atol=1e-5)
    _check_duals(got_lam.numpy(), lam)


def _small_qp():
    """The JAX package's gradient check QP (``tests/test_contact.py``), and
    three linear terms: q (one row active), q + 0.3 (no row active) and
    q - 0.2 (one row active)."""
    rng = np.random.RandomState(42)
    P = np.eye(3, dtype=np.float32)
    q = np.array([1., -2., 0.5], np.float32)
    C = rng.randn(4, 3).astype(np.float32)
    d = np.array([0.5, 0.3, -0.1, 1.0], np.float32)
    qs = np.stack([q, q + 0.3, q - 0.2]).astype(np.float32)
    return P, q, C, d, qs


def _resolution(P, q, C, d, iters):
    """float32 resolution of the implicit JVP's solve at this QP:
    cond(P + C' D C) * 2^-23, with D = lam/s of a float64 solve.  An
    active row at 40 iterations carries D ~ 1e5, and the JVP is then only
    determined to this accuracy in float32 (any reordering of a sum moves
    it that far); an inactive point has cond ~ 1."""
    x, s, lam = tqp._pdip_solve(*(_t(a).double() for a in (P, q, C, d)),
                                iters)
    D = torch.clamp(lam / torch.clamp(s, min=1e-8), max=tqp.W_CAP)
    H = _t(P).double() + (_t(C).double().T * D) @ _t(C).double()
    return float(np.linalg.cond(H.numpy())) * 2.0 ** -23


def test_solve_qp_jvp_matches_jax_and_finite_differences():
    """The JVP in all four inputs against ``jax.jvp`` of the JAX
    ``custom_jvp`` and against the port's own float64 evaluation, within
    the float32 resolution of the KKT solve (3.4e5 * 2^-23 = 4e-2 at this
    QP; measured 3.6e-3 apart); ``jacfwd`` against central differences at
    the JAX package's own atol 5e-2; at a point with no active row the
    JVP is exact to 1e-6."""
    P, q, C, d, qs = _small_qp()
    rng = np.random.RandomState(0)
    tangents = [rng.randn(*a.shape).astype(np.float32) for a in (P, q, C, d)]
    tangents[0] = 0.5 * (tangents[0] + tangents[0].T)
    for qq in (q, qs[1]):
        _, want = jax.jvp(lambda *a: jqp.solve_qp(*a, 40), (P, qq, C, d),
                          tuple(tangents))
        _, got = torch.func.jvp(lambda *a: tqp.solve_qp(*a, 40),
                                tuple(_t(a) for a in (P, qq, C, d)),
                                tuple(_t(t) for t in tangents))
        _, exact = torch.func.jvp(
            lambda *a: tqp.solve_qp(*a, 40),
            tuple(_t(a).double() for a in (P, qq, C, d)),
            tuple(_t(t).double() for t in tangents))
        tol = max(_resolution(P, qq, C, d, 40), 1e-6) \
            * float(exact.abs().max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
        np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=tol)
        np.testing.assert_allclose(np.asarray(want), exact.numpy(), atol=tol)
    assert _resolution(P, qs[1], C, d, 40) < 1e-6

    def f(qq):
        return tqp.solve_qp(_t(P), qq, _t(C), _t(d), 40)

    J = torch.func.jacfwd(f)(_t(q)).numpy()
    eps = 1e-2
    Jfd = np.stack([(f(_t(q + eps * e)) - f(_t(q - eps * e))).numpy()
                    / (2 * eps) for e in np.eye(3, dtype=np.float32)], 1)
    np.testing.assert_allclose(J, Jfd, atol=5e-2)


def test_solve_qp_jacobian_under_vmap():
    """jacfwd of a batch through vmap uses the generated vmap rule and
    gives each problem's own Jacobian: against the per-problem float64
    Jacobian and JAX's ``vmap(jacfwd)``, within each problem's float32
    resolution (see ``_resolution``; 1e-6 where no row is active)."""
    P, _, C, d, qs = _small_qp()

    def f(qq, dt=torch.float32):
        return tqp.solve_qp(_t(P).to(dt), qq, _t(C).to(dt), _t(d).to(dt), 40)

    batched = torch.func.vmap(torch.func.jacfwd(f))(_t(qs)).numpy()
    want = np.asarray(jax.vmap(jax.jacfwd(
        lambda qq: jqp.solve_qp(P, qq, C, d, 40)))(jnp.asarray(qs)))
    for i in range(3):
        exact = torch.func.jacfwd(lambda qq: f(qq, torch.float64))(
            _t(qs[i]).double()).numpy()
        tol = max(_resolution(P, qs[i], C, d, 40), 1e-6) \
            * np.abs(exact).max()
        np.testing.assert_allclose(batched[i], exact, atol=tol)
        np.testing.assert_allclose(batched[i], want[i], atol=tol)
