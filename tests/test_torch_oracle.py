"""The port's boxed ADMM and contact QP against the float64 oracles of the
JAX package's native library (``irs_mpc_tpu.native``, C++ through ctypes),
the cross-checks the JAX package's own tests make
(``tests/test_admm.py:87-110``, ``tests/test_contact.py:283-322``), on the
CPU and at their tolerances:

* ``ops.admm.solve_boxed_tvlqr`` on random tracking problems with a binding
  input box and a state box, against the dense box- and equality-
  constrained QP solved to 1e-12: x and u at rtol/atol 2e-2 after 300
  sweeps at rho 5 (ADMM converges linearly; the JAX package's criterion),
  the primal residual below 1e-3, the input box held within 1e-3.
* ``models.contact.qp.solve_qp`` on planar-hand contact-step QPs near the
  resting grasp, against the active-set oracle ``qp_ineq_solve_grad``:
  the solution at atol 1e-3, and its implicit-function JVP (through
  ``torch.func.jvp``) along a random bias tangent within 5 % of the
  oracle's active-set derivative, norm-relative (the PDIP's soft active
  set against the oracle's hard one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_tpu.native import (qp_box_eq_solve,  # noqa: E402
                                qp_ineq_solve_grad)
from irs_mpc_torch import make_planar_hand  # noqa: E402
from irs_mpc_torch.models.contact.qp import solve_qp  # noqa: E402
from irs_mpc_torch.ops import admm, lqr  # noqa: E402


def _random_problem(T=6, n=3, m=2, seed=0):
    """The JAX package's construction (``tests/test_admm.py:12-23``)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(T, n, n) * 0.3 + np.eye(n)
    B = rng.randn(T, n, m) * 0.5
    c = rng.randn(T, n) * 0.1
    Q = np.diag(rng.rand(n) + 0.5)
    R = np.diag(rng.rand(m) + 0.5)
    x0 = rng.randn(n) * 0.5
    xd = rng.randn(T + 1, n) * 0.5
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return lqr.build_tracking_problem(f(A), f(B), f(c), f(Q), f(Q * 3.0),
                                      f(R), f(x0), f(xd))


def _oracle_solve(prob, x_lb, x_ub, u_lb, u_ub):
    """The dense QP over w = [x_0..x_T, u_0..u_{T-1}] with the dynamics as
    equalities and a box on everything, solved in float64."""
    A, B, c = (prob.A.double().numpy(), prob.B.double().numpy(),
               prob.c.double().numpy())
    T, n, m = B.shape
    nx = (T + 1) * n
    nv = nx + T * m
    H, f = np.zeros((nv, nv)), np.zeros(nv)

    def xi(t):
        return slice(t * n, (t + 1) * n)

    def ui(t):
        return slice(nx + t * m, nx + (t + 1) * m)

    for t in range(T):
        H[xi(t), xi(t)] += 2 * prob.Q[t].double().numpy()
        H[ui(t), ui(t)] += 2 * prob.R[t].double().numpy()
        N = prob.N[t].double().numpy()
        H[xi(t), ui(t)] += 2 * N
        H[ui(t), xi(t)] += 2 * N.T
        f[xi(t)] += 2 * prob.q[t].double().numpy()
        f[ui(t)] += 2 * prob.r[t].double().numpy()
    H[xi(T), xi(T)] += 2 * prob.Qf.double().numpy()
    f[xi(T)] += 2 * prob.qf.double().numpy()
    E, d = np.zeros(((T + 1) * n, nv)), np.zeros((T + 1) * n)
    E[0:n, xi(0)] = np.eye(n)
    d[0:n] = prob.x0.double().numpy()
    for t in range(T):
        r0 = (t + 1) * n
        E[r0:r0 + n, xi(t)] = A[t]
        E[r0:r0 + n, ui(t)] = B[t]
        E[r0:r0 + n, xi(t + 1)] = -np.eye(n)
        d[r0:r0 + n] = -c[t]
    lb = np.concatenate([np.tile(x_lb, T + 1), np.tile(u_lb, T)])
    ub = np.concatenate([np.tile(x_ub, T + 1), np.tile(u_ub, T)])
    lb[0:n], ub[0:n] = -1e9, 1e9     # x_0 is pinned by the equalities
    w = qp_box_eq_solve(H, f, E, d, lb, ub, rho=10.0, iters=20000, tol=1e-12)
    return w[:nx].reshape(T + 1, n), w[nx:].reshape(T, m)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boxed_admm_matches_native_oracle(seed):
    prob = _random_problem(seed=seed)
    T, n, m = prob.B.shape
    u_lb, u_ub = -0.3 * np.ones(m), 0.3 * np.ones(m)
    x_lb, x_ub = -2.0 * np.ones(n), 2.0 * np.ones(n)

    def box(lo, hi, rows):
        return torch.tensor(np.stack([np.tile(lo, (rows, 1)),
                                      np.tile(hi, (rows, 1))]),
                            dtype=torch.float32)

    bounds = admm.BoxBounds(x=box(x_lb, x_ub, T + 1), u=box(u_lb, u_ub, T))
    sol = admm.solve_boxed_tvlqr(prob, bounds, n_phys=n, rho=5.0, iters=300)
    x_or, u_or = _oracle_solve(prob, x_lb, x_ub, u_lb, u_ub)
    assert float(sol.r_primal) < 1e-3
    np.testing.assert_allclose(sol.u_trj.numpy(), u_or, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(sol.x_trj.numpy(), x_or, rtol=2e-2, atol=2e-2)
    u = sol.u_trj.numpy()
    assert np.all(u <= u_ub + 1e-3) and np.all(u >= u_lb - 1e-3)
    assert np.abs(u_or).max() >= 0.3 - 1e-6      # the box binds


def test_contact_qp_and_jvp_match_native_active_set_oracle():
    model = make_planar_hand(h=0.1)
    q_nom = model.get_x_from_q_dict({
        "sphere": np.array([0.0, 0.35, 0.0]),
        "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
        "arm_right": np.array([np.pi / 4, np.pi / 4])})
    idx_u = model.indices_u_into_x()
    rng = np.random.RandomState(0)
    for trial in range(6):
        q = torch.tensor(q_nom + 0.005 * rng.randn(model.nq),
                         dtype=torch.float32)
        u = q[idx_u] + torch.tensor(0.01 * rng.randn(len(idx_u)),
                                    dtype=torch.float32)
        P, b = model._hessian_and_bias(q, u)
        G, phi = model.contact_rows(q)
        C, d = -G, phi
        x = solve_qp(P, b, C, d, model.qp_iters)
        args64 = [a.double().numpy() for a in (P, b, C, d)]
        xo, _, _ = qp_ineq_solve_grad(*args64)
        np.testing.assert_allclose(x.numpy(), xo, atol=1e-3)

        db = 0.1 * rng.randn(model.nq).astype(np.float32)
        _, jx = torch.func.jvp(
            lambda bb: solve_qp(P, bb, C, d, model.qp_iters), (b,),
            (torch.from_numpy(db),))
        _, _, dxo = qp_ineq_solve_grad(*args64, dq=db.astype(np.float64))
        err = np.linalg.norm(jx.numpy() - dxo) / max(1.0,
                                                     np.linalg.norm(dxo))
        assert err < 0.05, (trial, err)
