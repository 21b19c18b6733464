"""Port parity: the second-order contact engine of irs_mpc_torch
(``models/contact/mbp2d.py``) against the JAX package's, on the CPU.

* ``step`` and ``step_ws`` against the JAX package's, position and torque
  mode, on the planar hand (h=0.1) and box pushing (h=0.05), at states in
  and out of contact: atol 1e-5 (the same 30 / 10 PDIP iterations in
  float32).
* ``jacobian_xu`` (``torch.func.jacfwd`` through the implicit-function JVP)
  against ``jax.jacfwd``: out of contact within 1e-5 of the largest entry;
  in contact within the float32 resolution of the JVP's KKT solve that
  ``tests/test_torch_qp.py`` states for active rows, cond(P + C'DC) 2^-23
  of the largest entry, with D = lam/s of a float64 solve at that state
  (5 to 8 at these planar-hand states: there the JAX package's float32
  Jacobian is not determined).  The port solves that system in float64,
  so its Jacobian from float32 inputs is held to its float64 evaluation
  within 1e-5 of the largest entry in and out of contact (measured
  5.6e-7).
* ``estimation_surrogate`` (20 QP iterations) against the JAX package's.
* The JAX package's two mbp2d tests, ported
  (``tests/test_contact.py:237-283``): the hand settles the ball and
  differentiates; torque mode on a 1-dof-per-axis mass with no pairs.
* One iteration of the position-mode planar hand (T=8, 10 samples), in
  first_order and in zero_order_B with A from averaged first-order
  Jacobians.  With the JAX iteration's draws injected, the nominal steps
  agree at atol 2e-5 (velocities up to 1) and zero_order_B's B, a fit of
  sampled steps, within 1e-3 of its largest entry; the Jacobians of these
  contact states are not float32-determined in the JAX package (median
  resolution above 1, asserted), so the rest of the iteration runs in
  both packages from the JAX package's linearisation: cost channels rtol
  1e-4, trajectories atol 1e-4.
* The configurations of ``chip_smoke`` (the examples' full width) are the
  JAX examples', and their initial costs the JAX package's at rtol 1e-5.
* One CEM step on the second-order plant with the JAX step's noise
  injected, held as ``tests/test_torch_cem.py`` holds the contact CEM.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import box_pushing_second_order as jbox2  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_cem import _float64_costs  # noqa: E402
import irs_mpc_torch as tmpc  # noqa: E402
import planar_hand_second_order as jhand2  # noqa: E402
from irs_mpc_tpu.models.contact import geometry as jgeom  # noqa: E402
from irs_mpc_tpu.models.contact.mbp2d import Mbp2DModel as JMbp  # noqa: E402
from irs_mpc_tpu.models.contact.quasistatic import \
    ModelInstance as JInst  # noqa: E402
from irs_mpc_tpu.models.contact.quasistatic import \
    QuasistaticModel as JQm  # noqa: E402
from irs_mpc_tpu.models.contact.systems import (  # noqa: E402
    make_box_pushing, make_planar_hand)
from irs_mpc_tpu.ops.estimators import _sample_perturbations  # noqa: E402
from irs_mpc_tpu.solvers import irs_mpc as jirs  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.models.contact import qp as tqp  # noqa: E402
from irs_mpc_torch.ops import cuda_admm, cuda_riccati  # noqa: E402
from irs_mpc_torch.solvers import irs_mpc as tirs  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


MODELS = {
    "planar_hand": (lambda: make_planar_hand(h=0.1), (0.5, 0.3, 0.5, 0.3),
                    [0., 0.35, 0., -np.pi / 4, -np.pi / 4, np.pi / 4,
                     np.pi / 4]),
    "box_pushing": (lambda: make_box_pushing(h=0.05), (0.3, 0.3),
                    [0.0, 0.5, 0.0, 0.0, -0.11]),
}


def _models(name, mode):
    make, mass, _ = MODELS[name]
    jm = JMbp(base=make(), actuated_mass=mass, control_mode=mode,
              damping=0.5)
    return jm, convert.system_from_jax(jm)


def _states(name, mode, contact, B=6, seed=0):
    """B states (x, u) near the example's start: in contact (the ball on
    the arms, the pusher at the box) or with the object 0.3 away."""
    jm, _ = _models(name, mode)
    rng = np.random.RandomState(seed)
    q0 = np.array(MODELS[name][2], np.float32)
    nq = len(q0)
    q = q0 + rng.randn(B, nq) * 0.01
    if not contact:
        q[:, 1] += 0.3
    x = np.concatenate([q, rng.randn(B, nq) * 0.1], 1).astype(np.float32)
    idx = jm.indices_u_into_x()
    u = (q[:, idx] + rng.randn(B, len(idx)) * 0.03 if mode == "position"
         else rng.randn(B, len(idx)))
    return x, u.astype(np.float32)


CASES = [(name, mode) for name in MODELS for mode in ("position", "torque")]


@pytest.mark.parametrize("name, mode", CASES)
def test_step_and_step_ws_match_jax(name, mode):
    jm, tm = _models(name, mode)
    js, ts = jm.system(), tm.system()
    assert (ts.dim_x, ts.dim_u, ts.name) == (js.dim_x, js.dim_u, js.name)
    assert ts.est_sweep_fn is ts.ls_rollout_fn is ts.step_batch_fn is None
    for contact in (True, False):
        x, u = _states(name, mode, contact)
        want = np.asarray(jax.jit(jax.vmap(js.step))(x, u))
        got = ts.step(_t(x), _t(u)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        ws = jm.ws_init()
        jw = np.asarray(jax.jit(jax.vmap(
            lambda a, b: js.step_ws_fn(a, b, ws)[0]))(x, u))
        tw, (v, lam) = ts.step_ws_fn(_t(x), _t(u), tm.ws_init())
        np.testing.assert_allclose(tw.numpy(), jw, atol=1e-5)
        # The warm carry is (v', lam), not (dq, lam).
        np.testing.assert_array_equal(v.numpy(), tw[:, tm.nq:].numpy())
        assert lam.shape == (len(x), tm.base.n_constraint_rows())
    np.testing.assert_array_equal(tm.indices_u_into_x(),
                                  jm.indices_u_into_x())


def test_estimation_surrogate_matches_jax():
    """``estimation_surrogate`` runs the velocity QP at 20 iterations and
    keeps the warm chain only, as the JAX package's: its steps agree at
    atol 1e-5, in and out of contact."""
    jm, tm = _models("planar_hand", "position")
    js, ts = jm.estimation_surrogate(), tm.estimation_surrogate()
    assert ts.step_ws_fn is not None and ts.est_sweep_fn is None
    for contact in (True, False):
        x, u = _states("planar_hand", "position", contact)
        want = np.asarray(jax.jit(jax.vmap(js.step))(x, u))
        got = ts.step(_t(x), _t(u)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        if contact:
            # 20 PDIP iterations, not the model's 30.
            assert not np.array_equal(got, tm.system().step(_t(x),
                                                            _t(u)).numpy())


def _resolution(tm, x, u):
    """cond(P + C'DC) 2^-23 of the velocity QP at each state, D = lam/s of
    the float64 solve (the float32 resolution of the implicit JVP)."""
    xd, ud = _t(x).double(), _t(u).double()
    q, v_free, (P, b, C, d) = tm._split(xd, ud)
    _, s, lam = tqp._pdip_solve(P, b, C, d, tm.base.qp_iters)
    D = torch.clamp(lam / torch.clamp(s, min=1e-8), max=tqp.W_CAP)
    H = P + (C.transpose(-1, -2) * D.unsqueeze(-2)) @ C
    return np.linalg.cond(H.numpy()) * 2.0 ** -23


@pytest.mark.parametrize("name, mode", CASES)
def test_jacobian_matches_jax_at_the_kkt_resolution(name, mode):
    jm, tm = _models(name, mode)
    for contact in (False, True):
        x, u = _states(name, mode, contact, B=4, seed=1)
        want = np.asarray(jax.jit(jax.vmap(jm.system().jacobian_xu))(x, u))
        got = tm.system().jacobian_xu_batch(_t(x), _t(u)).numpy()
        assert got.shape == (4, 2 * tm.nq, 2 * tm.nq + tm.dim_u)
        scale = np.abs(want).max()
        res = np.maximum(_resolution(tm, x, u), 1e-5)
        if not contact:
            assert res.max() < 1e-4
        for g, w, r in zip(got, want, res):
            np.testing.assert_allclose(g / scale, w / scale, atol=r)
        exact = tm.system().jacobian_xu_batch(_t(x).double(),
                                              _t(u).double()).numpy()
        for g, e in zip(got, exact):
            np.testing.assert_allclose(g, e, atol=1e-5 * np.abs(e).max())


def test_mbp2d_settles_and_differentiates():
    base = tmpc.make_planar_hand(h=0.01)
    mbp = tmpc.Mbp2DModel(base=base, actuated_mass=(0.5, 0.3, 0.5, 0.3),
                          control_mode="position", damping=0.5)
    sys_ = mbp.system()
    assert sys_.dim_x == 14 and sys_.dim_u == 4
    q0 = np.array([0., 0.45, 0., -np.pi / 4, -np.pi / 4, np.pi / 4,
                   np.pi / 4], np.float32)
    x = torch.cat([_t(q0), torch.zeros(7)])
    u = _t(q0[[3, 4, 5, 6]])
    for _ in range(150):
        x = sys_.step(x, u)
    assert 0.3 < float(x[1]) < 0.6
    assert float(x[7:].abs().max()) < 1.0
    J = sys_.jacobian_xu(x, u)
    assert bool(torch.isfinite(J).all())


def test_mbp2d_torque_mode_gravity():
    """Torque mode on a pair-free 2-dof actuated mass: zero torque, no
    motion; a 1 N force on y gives v = h F / m after one step."""
    body = jgeom.FreeBody2D(idx_pos=(0, 1), idx_rot=None,
                            shapes=(jgeom.Circle((0., 0.), 0.1),))
    base = JQm(name="m", h=0.01, nq=2,
               models=(JInst("m", (0, 1), actuated=True,
                             stiffness=(10., 10.)),),
               bodies=(body,), pairs=(), gravity=(0.0, 0.0))
    jm = JMbp(base=base, actuated_mass=(1.0, 1.0), damping=0.0,
              control_mode="torque")
    tm = convert.system_from_jax(jm)
    sys_ = tm.system()
    assert sys_.step_ws_fn is None and tm.base.contact_rows(
        torch.zeros(2))[0] is None
    x = torch.zeros(4)
    np.testing.assert_allclose(sys_.step(x, torch.zeros(2)).numpy(),
                               np.zeros(4), atol=1e-7)
    x2 = sys_.step(x, torch.tensor([1.0, 0.0]))
    np.testing.assert_allclose(float(x2[2]), 0.01, atol=1e-6)
    np.testing.assert_allclose(
        x2.numpy(), np.asarray(jm.system().step(jnp.zeros(4),
                                                jnp.asarray([1.0, 0.0]))),
        atol=1e-7)


@pytest.mark.parametrize("mode", ["first_order", "zero_order_B"])
def test_injected_iteration_matches_jax(mode, monkeypatch):
    js, jm = jhand2.build_solver(gradient_mode=mode, num_samples=10, T=8)
    p = js.params
    it = jnp.asarray(1.0, jnp.float32)
    _, k_est = jax.random.split(js.key)
    sx, su = p.smoothing.stds(it, jm.dim_x, jm.dim_u)
    keys = jax.random.split(k_est, js.T)
    dx, du = jax.vmap(lambda k: _sample_perturbations(
        k, sx, su, p.smoothing.num_samples))(keys)
    ts = tmpc.IrsMpc(convert.system_from_jax(jm).system(),
                     convert.params_from_jax(
                         p, decay=lambda it: 1.0 / it ** 0.8), device="cpu")
    assert abs(ts.cost - js.cost) <= 1e-5 * js.cost
    jtv, _ = jax.jit(lambda x, u: jirs.estimate_tv_matrices_fnom(
        js.system, mode, x, u, k_est, it, p.smoothing))(js.x_trj, js.u_trj)
    jf = js.system.step_batch(js.x_trj[:-1], js.u_trj)
    draws = (torch.from_numpy(np.array(dx)), torch.from_numpy(np.array(du)))
    ttv, tf = tirs.estimate_tv_matrices_fnom(
        ts.system, mode, ts.x_trj, ts.u_trj, None, 1, ts.smoothing, draws)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5)
    if mode == "zero_order_B":
        # B fits sampled steps, which float32 determines; A averages the
        # first-order Jacobians of contact states, which it does not.
        scale = np.abs(np.asarray(jtv.B)).max()
        np.testing.assert_allclose(ttv.B.numpy() / scale,
                                   np.asarray(jtv.B) / scale, atol=1e-3)
    x_nom = (np.asarray(js.x_trj[:-1])[:, None] + np.array(dx)).reshape(
        -1, jm.dim_x)
    u_nom = (np.asarray(js.u_trj)[:, None] + np.array(du)).reshape(
        -1, jm.dim_u)
    assert np.median(_resolution(convert.system_from_jax(jm), x_nom,
                                 u_nom)) > 1.0

    # The rest of the iteration from the JAX package's linearisation.
    monkeypatch.setattr(jirs, "estimate_tv_matrices_fnom",
                        lambda *a, **k: (jtv, None))
    tv = tirs.TvLinearization(*(torch.from_numpy(np.array(a)) for a in jtv))
    monkeypatch.setattr(tirs, "estimate_tv_matrices_fnom",
                        lambda *a, **k: (tv, None))
    jx, ju, _, jcvec = jax.jit(js._iteration)(js.x_trj, js.u_trj, js.key, it)
    before = (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES)
    step = ts._iteration(ts.x_trj, ts.u_trj, 1)
    assert (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES) == before
    np.testing.assert_allclose(step.cvec.numpy(), np.asarray(jcvec),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(step.x.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(step.u.numpy(), np.asarray(ju), atol=1e-4)
    assert float(step.cvec[0]) < ts.cost


CONFIGS = {
    "position": (lambda: jhand2.build_solver(gradient_mode="exact")[0],
                 lambda: chip_smoke.planar_hand_second_solver(
                     "cpu", gradient_mode="exact")[0]),
    "position_spin": (lambda: jhand2.build_solver(spin=True)[0],
                      lambda: chip_smoke.planar_hand_second_solver(
                          "cpu", spin=True)[0]),
    "torque": (lambda: jhand2.build_solver(control_mode="torque")[0],
               lambda: chip_smoke.planar_hand_second_solver(
                   "cpu", control_mode="torque")[0]),
    "box_pushing": (lambda: jbox2.build_solver()[0],
                    lambda: chip_smoke.box_pushing_second_solver("cpu")[0]),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_smoke_configuration_is_the_example(name):
    """The second-order configurations of ``chip_smoke`` are the JAX
    examples' at full width: the parameters carried with
    ``convert.params_from_jax`` equal the smoke's, and the initial costs
    agree at rtol 1e-5."""
    js, ts = CONFIGS[name][0](), CONFIGS[name][1]()
    carried = convert.params_from_jax(js.params, decay=lambda it: it)
    for field in ("gradient_mode", "admm_iters", "bounds_trust_region",
                  "report_final_cost_with_Q", "line_search_alphas"):
        assert getattr(carried, field) == getattr(ts.params, field), field
    for field in ("Q", "Qd", "R", "x0", "xd_trj", "u_trj_init",
                  "u_bounds_abs", "indices_u_into_x", "unactuated_indices"):
        a, b = getattr(carried, field), getattr(ts.params, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b, a.numpy(
            ).dtype), err_msg=field)
    sm, ts_sm = js.params.smoothing, ts.params.smoothing
    for field in ("num_samples", "std_x", "std_u", "damp", "decay_std_x",
                  "zero_order_B_A_source"):
        assert getattr(sm, field) == getattr(ts_sm, field), field
    for it in (1.0, 2.0, 7.0):
        np.testing.assert_allclose(float(ts_sm.decay(torch.tensor(it))),
                                   float(sm.decay(jnp.float32(it))),
                                   rtol=1e-6)
    np.testing.assert_allclose(ts.cost, js.cost, rtol=1e-5)


def test_injected_cem_step_matches_jax():
    jc, jm = jhand2.build_cem_solver(T=8, batch_size=40, n_elite=6)
    tm = convert.system_from_jax(jm)
    tc = tmpc.CrossEntropyMethod(tm.system(),
                                 convert.cem_params_from_jax(jc.params),
                                 device="cpu")
    np.testing.assert_allclose(tc.cost, jc.cost, rtol=1e-5)
    p = jc.params
    _, k = jax.random.split(jc.key)
    eps = np.array(jax.random.normal(k, (p.batch_size, tc.T,
                                         jc.system.dim_u)))
    jc.iterate(1, verbose=False)
    st = tc._step(tc.u_trj, tc.std_trj, tc.x_trj, torch.tensor(tc.cost),
                  tc.kept, noise=torch.from_numpy(eps))
    cand = jnp.asarray(st.cand.numpy())
    want = np.asarray(jax.vmap(
        lambda u: jc._cost(jc.system.rollout(jc.x0, u), u))(cand))
    got = st.costs.numpy()
    # Held at 1e-4 where float32 determines a candidate's cost (the port's
    # chain within 1e-4 of the float64 chain), as the quasistatic CEM.
    c64 = _float64_costs(tc, tm, st.cand)
    held = np.abs(got - c64) <= 1e-4 * np.abs(c64)
    assert held.mean() >= 0.9, (~held).sum()
    np.testing.assert_allclose(got[held], want[held], rtol=1e-4)
    n = p.n_elite
    order = np.sort(want)
    assert order[n] - order[n - 1] > 2e-4 * abs(order[n])
    assert set(st.elite_idx.tolist()) == set(np.argsort(want)[:n].tolist())
    np.testing.assert_allclose(st.u.numpy(), np.asarray(jc.u_trj), atol=1e-5)
    np.testing.assert_allclose(st.std.numpy(), np.asarray(jc.std_trj),
                               atol=1e-5)
    np.testing.assert_allclose(st.kept.numpy(), np.asarray(jc.kept),
                               atol=1e-5)
    np.testing.assert_allclose(float(st.cost), jc.cost, rtol=1e-4)


def jax_seed_study(seeds, paths):
    """The JAX package's second-order example solvers for each seed: the
    best cost after 10 iterations, then each path's median."""
    import dataclasses
    import statistics

    import irs_mpc_tpu as jmpc
    builders = {
        "planar_hand_second_exact": lambda: jhand2.build_solver(
            gradient_mode="exact")[0],
        "planar_hand_second_first_order": lambda: jhand2.build_solver(
            gradient_mode="first_order")[0],
        "planar_hand_second_zero_order_B": lambda: jhand2.build_solver()[0],
        "planar_hand_second_torque": lambda: jhand2.build_solver(
            control_mode="torque")[0],
        "box_pushing_second_order": lambda: jbox2.build_solver()[0],
    }
    for label in paths:
        bests = []
        for seed in range(seeds):
            js = builders[label]()
            js = jmpc.IrsMpc(js.system, dataclasses.replace(js.params,
                                                            seed=seed))
            js.iterate(10, verbose=False)
            bests.append(float(js.cost_best))
            print(f"{label} seed {seed}: best {bests[-1]:.4f}", flush=True)
        print(f"{label}: median best {statistics.median(bests):.4f} over "
              f"seeds 0-{seeds - 1}; sorted "
              + " ".join(f"{b:.3f}" for b in sorted(bests))
              + " (JAX, the CPU)", flush=True)


if __name__ == "__main__" and "--jax-seeds" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[sys.argv.index("--jax-seeds") + 1:]
    jax_seed_study(int(args[0]), args[1].split(",") if len(args) > 1 else [
        "planar_hand_second_exact", "planar_hand_second_first_order",
        "planar_hand_second_zero_order_B", "planar_hand_second_torque",
        "box_pushing_second_order"])
