"""Port parity: the contact engine of irs_mpc_torch against irs_mpc_tpu.

The five contact models of the JAX package are carried into the port with
``convert.model_from_jax``; the same numpy states and inputs, made from a
seed, go through both.

* Narrow-phase primitives and the contact rows (signed distances, contact
  points and normals through the point Jacobians) of every model, atol
  1e-5 (float32 round-off of a few trigonometric and square-root ops).
* The QP's Hessian and bias, exactly; ``step`` and ``step_ws`` at
  contact-engaged states, atol 1e-5 (the same 30 / 10 PDIP iterations in
  float32; the step is ~1e-2).  ``canon_duals`` exactly.
* ``jacobian_xu`` (``torch.func.jacfwd`` through the implicit-function JVP
  of ``solve_qp``) against ``jax.jacfwd`` through its ``custom_jvp``: atol
  1e-4 of the largest entry with the planar-hand ball above the arms, and
  5e-3 at box-pushing states with a row at a gap of 5e-3 (there the JAX
  package's own eager and jitted Jacobians differ by 2.2e-3).  Where the
  ball rests on the arms, the JVP's KKT matrix
  has a condition number near 1e8 (active rows carry lam/s ~ 1e8), and
  either package's float32 Jacobian differs from a float64 evaluation by
  O(1) of its largest entry; there the test only asks for finite values
  and the ball-arm coupling in both.
* The whole-chain rollout's model table: the plain assembly from it
  against the JAX package's kernel-safe assembly (``assemble_xla``) and the
  port's own geometry, atol 1e-5, for all eleven pair kinds in both orders
  (the four bundled models within K4's limits and ``chip_smoke``'s
  circle-circle model, each also with its pairs' sides swapped), at seeded
  states and, for the boxes, at states inside the box, at a face tie and
  at the box's centre (ties pick axis 0, sign(0) is +1); and
  ``supports_model`` / ``chain_gate`` on all five models and that one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_tpu.models.contact import geometry as jgeom  # noqa: E402
import chip_smoke  # noqa: E402
from irs_mpc_tpu.models.contact import pallas_rollout as jpr  # noqa: E402
from irs_mpc_tpu.models.contact import quasistatic as jqs  # noqa: E402
from irs_mpc_tpu.models.contact import systems as jsys  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.models.contact import geometry as tgeom  # noqa: E402
from irs_mpc_torch.models.contact import rollout as trollout  # noqa: E402
from irs_mpc_torch.models.contact.systems import \
    make_planar_hand  # noqa: E402

NAMES = ["planar_hand", "box_pushing", "box_pivoting", "plate_pickup",
         "carrots"]


def _q0(name, model):
    if name == "planar_hand":
        return np.array([0.0, 0.35, 0.0, -np.pi / 4, -np.pi / 4, np.pi / 4,
                         np.pi / 4], np.float32)
    if name == "plate_pickup":
        return model.get_x_from_q_dict(
            {"plate": np.array([0.0, 0.04, 0.0]),
             "gripper": np.array([0.0, 0.30, 0.0, -0.16, -0.16])})
    if name == "box_pushing":
        return np.array([0., 0.5, 0., 0., -0.12], np.float32)
    if name == "box_pivoting":
        return np.array([0.45, 0.5, 0., -0.15, 0.5], np.float32)
    if name == "circle_pair":
        return np.asarray(chip_smoke.CONTACT_Q0[name], np.float32)
    rng = np.random.RandomState(0)              # carrots
    q = {"gripper": np.array([-0.85, 0.22, 0.0, -0.05, -0.05])}
    for k in range(20):
        q[f"carrot_{k}"] = np.array([rng.uniform(-0.6, 0.2), 0.05])
    return model.get_x_from_q_dict(q)


def _states(name, model, B=6, scale=0.05, seed=0):
    rng = np.random.RandomState(seed)
    q0 = _q0(name, model)
    x = (np.tile(q0, (B, 1)) + rng.randn(B, model.nq) * scale)
    u = (np.tile(q0[model.indices_u_into_x()], (B, 1))
         + rng.randn(B, model.dim_u) * scale)
    return x.astype(np.float32), u.astype(np.float32)


def _models(name):
    if name == "circle_pair":
        jm = chip_smoke.circle_pair_model(jgeom, jqs)
    else:
        jm = getattr(jsys, f"make_{name}")()
    return jm, convert.model_from_jax(jm)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_planar_hand_factory_matches_carried_model():
    jm, carried = _models("planar_hand")
    assert make_planar_hand() == carried


def test_narrow_phase_primitives_match_jax():
    rng = np.random.RandomState(1)
    B = 16
    ca, cb = rng.randn(B, 2).astype(np.float32), rng.randn(B, 2).astype(
        np.float32)
    a1 = ca + rng.randn(B, 2).astype(np.float32)
    th = rng.randn(B).astype(np.float32)
    cases = {
        "circle_circle": (lambda g, c1, c2, e, t: g.circle_circle(
            c1, 0.3, c2, 0.2)),
        "capsule_circle": (lambda g, c1, c2, e, t: g.capsule_circle(
            c1, e, 0.1, c2, 0.25)),
        "circle_halfspace": (lambda g, c1, c2, e, t: g.circle_halfspace(
            c1, 0.2, (0.6, 0.8), 0.1)),
        "point_halfspace": (lambda g, c1, c2, e, t: g.point_halfspace(
            c1, (0.0, 1.0), -0.2)),
        # Half widths of 1.5 put about half the circles inside the box.
        "circle_box": (lambda g, c1, c2, e, t: g.circle_box(
            c1, 0.1, c2, (1.5, 1.0), t)),
    }
    for name, fn in cases.items():
        want = jax.vmap(lambda c1, c2, e, t: fn(jgeom, c1, c2, e, t))(
            ca, cb, a1, th)
        got = fn(tgeom, _t(ca), _t(cb), _t(a1), _t(th))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       err_msg=name)
    want = jax.vmap(lambda c, t: jgeom.box_corners(c, (0.5, 0.2), t))(cb, th)
    got = tgeom.box_corners(_t(cb), (0.5, 0.2), _t(th))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", NAMES[:4])
def test_contact_rows_and_qp_terms_match_jax(name):
    jm, tm = _models(name)
    x, u = _states(name, jm, scale=0.06)
    G, phi = jax.vmap(jm.contact_rows)(x)
    Gt, phit = tm.contact_rows(_t(x))
    np.testing.assert_allclose(Gt.numpy(), np.asarray(G), atol=1e-5)
    np.testing.assert_allclose(phit.numpy(), np.asarray(phi), atol=1e-5)
    P, b = jax.vmap(jm._hessian_and_bias)(x, u)
    Pt, bt = tm._hessian_and_bias(_t(x), _t(u))
    np.testing.assert_array_equal(Pt.numpy(), np.asarray(P))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(b))
    assert tm.n_constraint_rows() == jm.n_constraint_rows()


@pytest.mark.parametrize("name", ["planar_hand", "box_pushing"])
def test_step_and_warm_step_match_jax(name):
    jm, tm = _models(name)
    x, u = _states(name, jm, scale=0.02)
    want = jax.vmap(jm.step)(x, u)
    got = tm.step(_t(x), _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # The resting planar-hand states are in contact: the rows bind.
    if name == "planar_hand":
        _, phi = tm.contact_rows(_t(x))
        assert float(phi.abs().min()) < 0.05

    rng = np.random.RandomState(2)
    mr = jm.n_constraint_rows()
    dq0 = (rng.randn(len(x), jm.nq) * 0.01).astype(np.float32)
    lam0 = (np.abs(rng.randn(len(x), mr)) + 0.5).astype(np.float32)
    jx, (jdq, jlam) = jax.vmap(jm.step_ws)(x, u, (dq0, lam0))
    tx, (tdq, tlam) = tm.step_ws(_t(x), _t(u), (_t(dq0), _t(lam0)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(tdq.numpy(), np.asarray(jdq), atol=1e-5)
    lam = np.abs(rng.randn(3, mr)).astype(np.float32)
    np.testing.assert_array_equal(tm.canon_duals(_t(lam)).numpy(),
                                  np.asarray(jm.canon_duals(lam)))


def _jacobians(name, x, u):
    jm, tm = _models(name)
    want = np.asarray(jax.jit(jax.vmap(jm.system().jacobian_xu))(x, u))
    got = tm.system().jacobian_xu_batch(_t(x), _t(u)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    return got, want


def test_jacobian_matches_jax_jacfwd():
    rng = np.random.RandomState(0)
    xb = (np.array([0., 0.5, 0., 0., -0.12])
          + rng.randn(4, 5) * 0.01).astype(np.float32)
    got, want = _jacobians("box_pushing", xb, xb[:, 3:5] + 0.01)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-3)
    # Planar hand: four states with the ball 0.3 above the arms, then four
    # with it resting on them.
    x = (_q0("planar_hand", None) + rng.randn(8, 7) * 0.01).astype(
        np.float32)
    x[:4, 1] += 0.3
    u = x[:, 3:7] + (rng.randn(8, 4) * 0.02).astype(np.float32)
    got, want = _jacobians("planar_hand", x, u)
    scale = np.abs(want[:4]).max()
    np.testing.assert_allclose(got[:4] / scale, want[:4] / scale, atol=1e-4)
    for J in (got[4:], want[4:]):
        assert np.isfinite(J).all() and np.abs(J[:, :3, 7:]).max() > 1e-2


# Box states (box y, z, th; hand y, z) of the two box models: the hand
# inside a turned box, on the diagonal of the box (both faces equally near:
# the tie picks axis 0) and at the box's centre (a tie, and sign(0) = +1).
BOX_STATES = np.array([[0.0, 0.5, 0.3, 0.1, 0.4],
                       [0.0, 0.5, 0.0, 0.25, 0.75],
                       [0.0, 0.5, 0.0, 0.0, 0.5]], np.float32)


@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize("name", ["planar_hand", "box_pushing",
                                  "box_pivoting", "plate_pickup",
                                  "circle_pair"])
def test_table_assembly_matches_jax_kernel_assembly(name, swapped):
    jm, tm = _models(name)
    if swapped:
        jm, tm = chip_smoke.swap_pairs(jm), chip_smoke.swap_pairs(tm)
    assert trollout.supports_model(tm) and jpr.supports_model(jm)
    consts = trollout.make_consts(tm)
    assert consts["rows"] == tm.n_constraint_rows() == jm.n_constraint_rows()
    for seed in (0, 1, None):
        x, u = _states(name, jm, B=8, scale=0.06, seed=seed or 0)
        if seed is None:
            if not name.startswith("box"):
                continue
            x, u = BOX_STATES, BOX_STATES[:, 3:] + np.float32(0.01)
        b, C, d = jpr.assemble_xla(jm, jnp.asarray(x), jnp.asarray(u))
        bt, Ct, dt = trollout.assemble(consts, _t(x), _t(u))
        np.testing.assert_allclose(Ct.numpy(), np.asarray(C), atol=1e-5)
        np.testing.assert_allclose(dt.numpy(), np.asarray(d), atol=1e-5)
        scale_b = float(np.abs(np.asarray(b)).max()) + 1.0
        np.testing.assert_allclose(bt.numpy() / scale_b,
                                   np.asarray(b) / scale_b, atol=1e-5)
        # ... and the port's own geometry.
        Cg, dg = tm._constraint_rows(_t(x))
        np.testing.assert_allclose(Ct.numpy(), Cg.numpy(), atol=1e-5)
        np.testing.assert_allclose(dt.numpy(), dg.numpy(), atol=1e-5)
    if name.startswith("box"):
        # Inside the box every hand row is a push-out of depth >= 0.1.
        assert (dt.numpy()[:, -2:] < -0.1).all()
    np.testing.assert_array_equal(consts["pdiag"].numpy(),
                                  jpr._hessian_constants(jm)[0])


# (supports_model, chain_gate), the JAX package's: plate pickup's fingers
# keep it off the whole chain, carrots is past the kernel's limits.
GATES = {"planar_hand": (True, True), "box_pushing": (True, True),
         "box_pivoting": (True, True), "plate_pickup": (True, False),
         "carrots": (False, False), "circle_pair": (True, True)}


@pytest.mark.parametrize("name", NAMES + ["circle_pair"])
def test_supports_model_and_chain_gate(name):
    jm, tm = _models(name)
    supported, gated = GATES[name]
    assert trollout.supports_model(tm) == supported == jpr.supports_model(jm)
    assert trollout.chain_gate(tm) == gated == jpr.chain_gate(jm)
    has_fn = tm.system().ls_rollout_fn is not None
    assert has_fn == (supported and gated)
    assert has_fn == (jm.system().ls_rollout_fn is not None)
    lcp = dataclasses.replace(tm, contact_model="lcp")
    assert not trollout.supports_model(lcp)
