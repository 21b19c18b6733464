"""Port parity: ``forward_mode="resolve"`` of irs_mpc_torch against
irs_mpc_tpu's, on the CPU (the plain Riccati pass and ADMM loop).

Exact mode draws no samples, so both packages follow the same curve: the
cost curves at rtol 1e-4 and the final inputs at atol 1e-4.  The cases are
those of ``tests/test_irs_mpc.py:119-154`` (a non-binding and a binding
input box on the pendulum) at T = 12 and 3 iterations instead of T = 40-50
and 5, the binding box narrowed from +-2 to +-1.2 so that it still binds
over the shorter horizon: the port's plain ADMM loop runs T full-horizon
solves an iteration, as Python loops, and the JAX package's resolve curves
at T = 12 exercise the same masking (padded stages, masked boxes, the
final state's box).  Three
more cases cover the other augmentations: Δu mode with a trust-region box,
relative input bounds in plain-u mode, and no bounds at all (the
unconstrained solve at every knot).  The card case (T launches each of K1
and K3 an iteration, the CPU's curve at rtol 1e-3) is in
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import irs_mpc_tpu as jmpc  # noqa: E402
import irs_mpc_torch as tmpc  # noqa: E402
from irs_mpc_torch.ops import cuda_admm, cuda_riccati  # noqa: E402

T, ITERATIONS = 12, 3
CASES = {
    "non_binding_box": dict(u_bounds_abs=np.array([[-1e4], [1e4]]),
                            admm_iters=25),
    "binding_box": dict(u_bounds_abs=np.array([[-1.2], [1.2]]),
                        admm_iters=40),
    "delta_u_trust_region": dict(indices_u_into_x=np.array([0]),
                                 u_bounds_abs=np.array([[-0.3], [0.3]]),
                                 bounds_trust_region=True, admm_iters=20),
    "rel_bounds": dict(u_bounds_rel=np.array([[-0.5], [0.5]]),
                       u_bounds_abs=np.array([[-2.], [2.]]), admm_iters=20),
    "no_bounds": dict(),
}


def _params(pkg, forward_mode="resolve", **kw):
    return pkg.IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode="exact",
        forward_mode=forward_mode, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_resolve_curve_matches_jax(case):
    kw = CASES[case]
    js = jmpc.IrsMpc(jmpc.make_pendulum(0.05), _params(jmpc, **kw))
    ts = tmpc.IrsMpc(tmpc.make_pendulum(0.05), _params(tmpc, **kw),
                     device="cpu")
    js.iterate(ITERATIONS, verbose=False)
    before = (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES)
    ts.iterate(ITERATIONS, verbose=False)
    assert (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES) == before
    np.testing.assert_allclose(ts.cost_lst, js.cost_lst, rtol=1e-4)
    for a, b in zip(ts.stats_lst, js.stats_lst):
        np.testing.assert_allclose(
            [a.cost_Qa, a.cost_Qa_final, a.cost_R],
            [b.cost_Qa, b.cost_Qa_final, b.cost_R], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.u_trj.numpy(), np.asarray(js.u_trj),
                               atol=1e-4)
    if case == "binding_box":
        assert np.abs(ts.u_trj.numpy()).max() <= 1.2 + 1e-3
        assert np.abs(ts.u_trj.numpy()).max() >= 1.2 - 1e-3   # it binds


def test_resolve_keeps_the_nominal_when_the_resolve_diverges():
    """A non-finite re-solved trajectory is replaced by the nominal and its
    cost, as in the JAX package (no line search in resolve mode)."""
    ts = tmpc.IrsMpc(tmpc.make_pendulum(0.05), _params(tmpc),
                     device="cpu")
    real = ts._resolve_forward

    def diverging(prob, x_trj):
        x, u = real(prob, x_trj)
        return x * float("nan"), u
    ts._resolve_forward = diverging
    ts.iterate(1, verbose=False)
    assert ts.cost_lst[1] == pytest.approx(ts.cost_lst[0], rel=1e-6)
    np.testing.assert_array_equal(ts.u_trj.numpy(), ts.u_trj_lst[0].numpy())


def test_contact_resolve_forward_matches_jax_on_one_problem():
    """The planar hand's resolve forward pass (Δu mode, trust-region boxes,
    12 over-relaxed sweeps a knot, the warm contact chain) on one problem,
    the JAX package's first exact-mode problem carried across: x and u at
    atol 1e-5.  Whole iterations are not compared: the exact Jacobian of a
    contact step is float32-determined only to cond 2^-23 (cond 1e5-1e6,
    ``tests/test_torch_qp.py``), and resolve has no line search to absorb
    that."""
    import dataclasses
    import sys
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    from irs_mpc_tpu.ops.estimators import (decouple_AB,
                                            estimate_tv_matrices_fnom)
    from irs_mpc_torch import convert

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                           / "examples"))
    import planar_hand

    js, jm = planar_hand.build_solver(num_samples=4, T=5)
    jp = dataclasses.replace(js.params, gradient_mode="exact",
                             forward_mode="resolve")
    js = jmpc.IrsMpc(js.system, jp)
    @jax.jit
    def jax_problem_and_resolve(x_trj, u_trj):
        tv, f_nom = estimate_tv_matrices_fnom(
            js.system, "exact", x_trj, u_trj, js.key, jnp.float32(1.0),
            jp.smoothing)
        tv = decouple_AB(tv, js.idx_u, x_trj, u_trj, js.system, f_nom=f_nom)
        prob = js._build_problem(tv, x_trj)
        return prob, js._resolve_forward(prob, x_trj, u_trj)

    prob, (jx, ju) = jax_problem_and_resolve(js.x_trj, js.u_trj)

    tm = convert.model_from_jax(jm)
    ts = tmpc.IrsMpc(tm.system(), convert.params_from_jax(
        jp, decay=lambda it: 1.0 / it ** 0.8,
        estimation_system=tm.estimation_surrogate()), device="cpu")
    tx, tu = ts._resolve_forward(convert.problem_from_numpy(*prob),
                                 ts.x_trj)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
