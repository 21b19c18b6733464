"""Port parity: the planar-hand contact iRS-MPC slice of irs_mpc_torch
against irs_mpc_tpu, on the CPU (the plain versions of K1-K4).

The configuration is the JAX package's own (``examples/planar_hand.py``):
T=30, 50 samples per knot, zero_order_B with decoupled A/B, Δu mode,
trust-region input boxes of +-0.5h, boxed ADMM at 12 sweeps with a=1.6, the
15-iteration estimation surrogate, 6 line-search alphas.  The JAX model and
parameters are carried into the port with ``convert``.

* The fused estimation sweep and the warm-started PDIP of the chain against
  the JAX package's (atol 1e-5: the same float32 iterations).
* The plain whole-chain rollout (K4's plain version): open loop against
  the warm ``step_ws`` chain of both packages (atol 1e-5; measured 1.2e-7),
  and on the line search of the slice's first iteration against the
  solver's step_ws loop (atol 1e-4).  The JAX package's own chain check
  allows atol 5e-3.
* One iteration with the JAX iteration's samples injected: the JAX package
  holds its whole-chain kernel to its scan path at atol 0.05; the port
  earns atol 1e-4 on the accepted trajectories (measured 3.5e-6) and rtol
  1e-4 on the cost channels (measured 6e-6), except the two that are
  differences, cost_Qa = cx - cost_Qu and cost_Qa_final, which each
  package's float32 rounding of the minuend cx decides only to about one
  ulp of cx: those are held to 2 ulps of their minuend, twice the gap
  measured on an x86-64 CPU where the former atol 1e-6 failed (cost_Qa
  4.615784e-4 against JAX's 4.653931e-4, 1 ulp = 3.8147e-6;
  cost_Qa_final equal).
* The golden of ``tests/test_golden_contact.py`` with the port's own random
  stream: initial 325.0136 at rtol 1e-3, best within 12% of 22.26 after 8
  descents, without a kernel launch and without an exact Jacobian.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import chip_smoke  # noqa: E402
import irs_mpc_torch as tmpc  # noqa: E402
from irs_mpc_tpu.models.contact import pallas_rollout as jpr  # noqa: E402
from irs_mpc_tpu.ops.estimators import _sample_perturbations  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.models import base  # noqa: E402
from irs_mpc_torch.models.contact import cuda_qp, cuda_rollout  # noqa: E402
from irs_mpc_torch.models.contact import rollout as trollout  # noqa: E402
from irs_mpc_torch.models.contact.qp import _pdip_solve  # noqa: E402
from irs_mpc_torch.ops import cuda_admm, cuda_riccati  # noqa: E402
from planar_hand import build_solver  # noqa: E402

KERNELS = (cuda_riccati, cuda_qp, cuda_admm, cuda_rollout)
T, S = 30, 50


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _launches():
    return [mod.LAUNCHES for mod in KERNELS]


@pytest.fixture(scope="module")
def jax_iteration():
    """The JAX solver, its first iteration's (dx, du) draws and results."""
    js, jm = build_solver(num_samples=S, T=T)
    p = js.params
    _, k_est = jax.random.split(js.key)
    sx, su = p.smoothing.stds(jnp.asarray(1.0, jnp.float32), jm.nq,
                              jm.dim_u)
    keys = jax.random.split(k_est, T)
    dx, du = jax.vmap(lambda k: _sample_perturbations(k, sx, su, S))(keys)
    out = js._iteration_jit(js.x_trj, js.u_trj, js.key,
                            jnp.asarray(1.0, jnp.float32))
    return js, jm, (np.array(dx), np.array(du)), [np.asarray(o)
                                                  for o in out]


def _port_solver(js, jm):
    tm = convert.model_from_jax(jm)
    tp = convert.params_from_jax(
        js.params, decay=lambda it: 1.0 / it ** 0.8,
        estimation_system=tm.estimation_surrogate())
    return tmpc.IrsMpc(tm.system(), tp, device="cpu"), tm


def test_estimation_sweep_matches_jax(jax_iteration):
    js, jm, (_, du), _ = jax_iteration
    tm = convert.model_from_jax(jm)
    x_nom, u_nom = np.asarray(js.x_trj[:-1]), np.asarray(js.u_trj)
    sweep = jm.estimation_surrogate().est_sweep_fn
    jf, jfd = jax.jit(lambda x, u, d: sweep(x, u, None, d))(x_nom, u_nom, du)
    tf, tfd = tm.estimation_surrogate().est_sweep_fn(_t(x_nom), _t(u_nom),
                                                     None, _t(du))
    assert tfd.shape == (T, S, jm.nq)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(tfd.numpy(), np.asarray(jfd), atol=1e-5)


def test_dense_warm_pdip_matches_jax():
    jm = build_solver(num_samples=4, T=2)[1]
    tm = convert.model_from_jax(jm)
    q0 = tm.get_x_from_q_dict(chip_smoke.HAND_Q0)
    rng = np.random.RandomState(0)
    x = (q0 + rng.randn(8, 7) * 0.05).astype(np.float32)
    u = (q0[3:] + rng.randn(8, 4) * 0.05).astype(np.float32)
    b, C, d = jax.jit(lambda x, u: jpr.assemble_xla(jm, x, u))(x, u)
    dq0 = (rng.randn(8, 7) * 0.01).astype(np.float32)
    lam0 = (np.abs(rng.randn(8, C.shape[1])) + 0.5).astype(np.float32)
    # Eager, as the JAX package's own check runs it: its jitted evaluation
    # differs from the eager one by 4.7e-5 (fused float32 arithmetic on
    # the active rows), the port from the eager one by 4.5e-6.
    jx, _ = jpr._pdip_warm_dense(jpr.make_consts(jm), b, C, d, dq0, lam0,
                                 iters=10)
    consts = trollout.make_consts(tm)
    tx, tlam = trollout._pdip_warm_dense(consts, _t(b), _t(C), _t(d),
                                         _t(dq0), _t(lam0), 10)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert np.isfinite(tlam.numpy()).all() and (tlam.numpy() >= 0).all()
    # ... and the general warm PDIP on the same QPs, at the JAX package's
    # own tolerance for that comparison.
    P, _ = tm._hessian_and_bias(_t(x), _t(u))
    xr, _, _ = _pdip_solve(P, _t(b), _t(C), _t(d), 10,
                           init=(_t(dq0), _t(lam0)))
    np.testing.assert_allclose(tx.numpy(), xr.numpy(), atol=5e-4)


def test_open_loop_chain_matches_step_ws():
    """Zero gains make the chain open loop: its lanes follow the warm
    ``step_ws`` chain of the port and of the JAX package."""
    solver, tm = chip_smoke.planar_hand_solver("cpu", T=8, num_samples=4)
    jm = build_solver(num_samples=4, T=8)[1]
    Tc, nq, m = 8, tm.nq, tm.dim_u
    q0 = solver.x0
    rng = np.random.RandomState(0)
    u_seq = _t(np.tile(q0[3:].numpy(), (Tc, 1))
               + np.cumsum(rng.randn(Tc, m) * 0.02, axis=0))
    A = 2
    xs, us = trollout.linesearch_rollout_plain(
        tm, q0, q0[3:], torch.zeros(Tc, m, nq + m), torch.zeros(A, Tc, nq),
        torch.zeros(A, Tc, m), u_seq.expand(A, Tc, m),
        torch.full((Tc, m), -torch.inf), torch.full((Tc, m), torch.inf),
        None, None)
    np.testing.assert_array_equal(us[1].numpy(), u_seq.numpy())
    ref = tm.system().rollout(q0, u_seq)
    np.testing.assert_allclose(xs[0].numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(xs[1].numpy(), ref.numpy(), atol=1e-5)
    jref = jm.system().rollout(jnp.asarray(q0.numpy()),
                               jnp.asarray(u_seq.numpy()))
    np.testing.assert_allclose(xs[0].numpy(), np.asarray(jref), atol=1e-5)


def test_injected_iteration_matches_jax(jax_iteration, monkeypatch):
    js, jm, draws, (jx, ju, _, jcvec) = jax_iteration
    ts, tm = _port_solver(js, jm)
    assert ts.system.ls_rollout_fn is not None
    assert abs(ts.cost - js.cost) <= 1e-5 * js.cost
    np.testing.assert_allclose(ts.x_trj.numpy(), np.asarray(js.x_trj),
                               atol=1e-5)
    chains = []
    lanes = base.System.rollout_lanes

    def recording(self, *args):
        out = lanes(self, *args)
        chains.append((args, out))
        return out

    monkeypatch.setattr(base.System, "rollout_lanes", recording)
    before = _launches()
    step = ts._iteration(ts.x_trj, ts.u_trj, 1,
                         perturbations=tuple(map(torch.from_numpy, draws)))
    assert _launches() == before               # the plain loop
    cvec = step.cvec.numpy()
    plain = [0, 1, 2, 5]                 # total, cost_Qu, cost_Qu_final, R
    np.testing.assert_allclose(cvec[plain], jcvec[plain], rtol=1e-4,
                               atol=1e-6)
    # cost_Qa = cx - cost_Qu and cost_Qa_final = cxf - cost_Qu_final are
    # small differences of float32 sums near 34 and 46 (ulp 3.8e-6) that
    # each package rounds its own way: they are determined only to about
    # one ulp of their minuend.
    for diff, qu in ((3, 1), (4, 2)):
        ulp = np.spacing(np.float32(jcvec[qu] + jcvec[diff]))
        np.testing.assert_allclose(cvec[diff], jcvec[diff], rtol=1e-4,
                                   atol=max(1e-6, 2 * ulp))
    np.testing.assert_allclose(step.x.numpy(), jx, atol=1e-4)
    np.testing.assert_allclose(step.u.numpy(), ju, atol=1e-4)
    assert float(step.cvec[0]) < ts.cost

    # K4's plain version on this line search agrees with the plain loop of
    # ``System.rollout_lanes``, lane by lane.
    args, (xs, us) = chains[0]
    assert args[4] is not None                 # Δu mode: z = [x; u_prev]
    xs_c, us_c = trollout.linesearch_rollout_plain(tm, *args)
    n = tm.nq
    assert xs_c.shape == (len(ts._alphas), T + 1, n)
    np.testing.assert_allclose(xs_c.numpy(), xs.numpy(), atol=1e-4)
    np.testing.assert_allclose(us_c.numpy(), us.numpy(), atol=1e-4)


def test_planar_hand_golden_on_cpu(monkeypatch):
    """The solver of ``chip_smoke.py`` on the CPU.  zero_order_B with
    decoupled A/B never needs the exact Jacobian of the contact step."""
    def no_jacobian(*args):
        raise AssertionError("the exact Jacobian was computed")

    monkeypatch.setattr(base.System, "jacobian_xu", no_jacobian)
    monkeypatch.setattr(base.System, "jacobian_xu_batch", no_jacobian)
    solver, model = chip_smoke.planar_hand_solver("cpu")
    assert solver.T == 30 and solver.smoothing.num_samples == 50
    before = _launches()
    solver.iterate(8, verbose=False)
    assert _launches() == before
    np.testing.assert_allclose(solver.cost_lst[0], 325.0136, rtol=1e-3)
    assert abs(solver.cost_best - 22.26) <= 0.12 * 22.26
    assert solver.x_trj.shape == (31, 7) and solver.u_trj.shape == (30, 4)
    assert all(t.device.type == "cpu" for t in (solver.x_trj, solver.u_trj))


def test_carried_model_and_params_give_the_smoke_configuration(
        jax_iteration):
    js, jm, _, _ = jax_iteration
    ts, tm = _port_solver(js, jm)
    smoke, smoke_model = chip_smoke.planar_hand_solver("cpu")
    assert tm == smoke_model
    for f in ("Q", "Qd", "R", "x0", "xd_trj", "u_trj"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      getattr(smoke, f).numpy())
    for f in dataclasses.fields(smoke.params):
        if f.name in ("smoothing", "estimation_system"):
            continue
        a, b = getattr(ts.params, f.name), getattr(smoke.params, f.name)
        if isinstance(b, np.ndarray):       # carried as float32
            a, b = np.asarray(a, b.dtype), np.asarray(b, np.float32)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert ts.smoothing.stds(3, 7, 4)[1].tolist() == \
        smoke.smoothing.stds(3, 7, 4)[1].tolist()
