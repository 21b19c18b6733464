"""Port parity: K4 and its plain chain on arms of any link count.

The JAX package's whole-chain kernel takes an ``Arm2D`` of any length; the
port's table keeps every arm's links in a link table of its own
(``rollout.make_consts``), so ``supports_model`` and ``chain_gate`` agree
with the JAX package's on every model.  The model with a six-link arm is
``chip_smoke.long_arm_model``, built in both packages from the same code
and carried by ``convert.system_from_jax``; inputs are made from a seed
with numpy.

* The gates on the five bundled models and on arms of 2, 6 and 8 links.
* The plain assembly from the table against the JAX package's kernel-safe
  assembly (``assemble_xla``) and the port's own geometry, atol 1e-5, as
  ``tests/test_torch_contact.py`` holds the bundled models.
* The plain chain against the JAX package's warm scan chain (``step_ws``),
  atol 5e-3 (``tests/test_torch_box.py``).
* ``csrc/rollout.cu`` through the CPU shim against the plain chain, at
  ``chip_smoke.CHAIN_ATOL`` (``tests/test_torch_kernels.py``).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from irs_mpc_tpu.models.contact import geometry as jgeom  # noqa: E402
from irs_mpc_tpu.models.contact import pallas_rollout as jpr  # noqa: E402
from irs_mpc_tpu.models.contact import quasistatic as jqs  # noqa: E402
from irs_mpc_tpu.models.contact import systems as jsys  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.models.contact import cuda_rollout  # noqa: E402
from irs_mpc_torch.models.contact import geometry as tgeom  # noqa: E402
from irs_mpc_torch.models.contact import quasistatic as tqs  # noqa: E402
from irs_mpc_torch.models.contact import rollout as trollout  # noqa: E402

BUNDLED = ["planar_hand", "box_pushing", "box_pivoting", "plate_pickup",
           "carrots"]
Q0 = np.asarray(chip_smoke.CONTACT_Q0["long_arm"], np.float32)


def _long_arm(links=6):
    jm = chip_smoke.long_arm_model(jgeom, jqs, links)
    return jm, convert.system_from_jax(jm)


def _models(name):
    if name.startswith("long_arm"):
        return _long_arm(int(name.rsplit("_", 1)[1]))
    jm = getattr(jsys, f"make_{name}")()
    return jm, convert.system_from_jax(jm)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_long_arm_built_in_the_port_is_the_carried_model():
    jm, carried = _long_arm()
    assert chip_smoke.long_arm_model(tgeom, tqs) == carried
    assert carried.nq == 11 and carried.dim_u == 8
    assert len(carried.bodies[1].link_lengths) == 6


@pytest.mark.parametrize("name", BUNDLED + ["long_arm_2", "long_arm_6",
                                            "long_arm_8"])
def test_gates_match_jax(name):
    jm, tm = _models(name)
    assert trollout.supports_model(tm) == jpr.supports_model(jm)
    assert trollout.chain_gate(tm) == jpr.chain_gate(jm)
    has_fn = tm.system().ls_rollout_fn is not None
    assert has_fn == (jm.system().ls_rollout_fn is not None)
    if name.startswith("long_arm"):
        # Every arm, whatever its length, is a capsule chain for K4.
        assert has_fn and trollout.supports_model(tm)


@pytest.mark.parametrize("links", [6, 8])
def test_link_table_holds_every_arm_once(links):
    _, tm = _long_arm(links)
    c = trollout.make_consts(tm)
    assert c["links"] == links + 2
    np.testing.assert_array_equal(c["link_i"].numpy(),
                                  np.arange(3, 3 + links + 2))
    np.testing.assert_allclose(c["link_f"].numpy(),
                               [0.13] * links + [0.2, 0.2])
    # Side a of the right arm's pairs names its first record.
    right = c["pair_i"].numpy()[links:links + 2, 2:2 + trollout.SIDE_INTS]
    assert (right[:, 5] == links).all()
    assert c["rows"] == tm.n_constraint_rows() == 2 * (links + 3)


@pytest.mark.parametrize("swapped", [False, True])
def test_table_assembly_matches_jax_kernel_assembly(swapped):
    jm, tm = _long_arm()
    if swapped:
        jm, tm = chip_smoke.swap_pairs(jm), chip_smoke.swap_pairs(tm)
    consts = trollout.make_consts(tm)
    rng = np.random.RandomState(0)
    x = (Q0 + rng.randn(8, tm.nq) * 0.06).astype(np.float32)
    u = (x[:, tm.indices_u_into_x()]
         + rng.randn(8, tm.dim_u) * 0.06).astype(np.float32)
    b, C, d = jpr.assemble_xla(jm, jnp.asarray(x), jnp.asarray(u))
    bt, Ct, dt = trollout.assemble(consts, _t(x), _t(u))
    np.testing.assert_allclose(Ct.numpy(), np.asarray(C), atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(d), atol=1e-5)
    scale_b = float(np.abs(np.asarray(b)).max()) + 1.0
    np.testing.assert_allclose(bt.numpy() / scale_b, np.asarray(b) / scale_b,
                               atol=1e-5)
    Cg, dg = tm._constraint_rows(_t(x))
    np.testing.assert_allclose(Ct.numpy(), Cg.numpy(), atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), dg.numpy(), atol=1e-5)
    # The distal links' rows carry the joints of every link before them.
    rows = Ct.numpy()[:, 10:12]                     # link 5 of the long arm
    assert (np.abs(rows[:, :, 3:9]).max(axis=(0, 1)) > 1e-3).all()


def _jax_warm_chain(jm, q0, u_seq):
    sys_ = jm.system()

    def f(carry, u):
        x, ws = carry
        xn, ws = sys_.step_ws_fn(x, u, ws)
        return (xn, ws), xn

    _, xs = jax.lax.scan(f, (jnp.asarray(q0), sys_.ws_init_fn()),
                         jnp.asarray(u_seq))
    return np.asarray(xs)


def test_plain_chain_matches_jax_warm_scan():
    jm, tm = _long_arm()
    T, A, nq, m = 8, 2, tm.nq, tm.dim_u
    u0 = Q0[tm.indices_u_into_x()]
    rng = np.random.RandomState(0)
    # The long arm's last joints curl onto the ball, knot by knot.
    drift = np.zeros(m, np.float32)
    drift[3:6] = -0.02
    u_seq = (u0 + np.arange(1, T + 1)[:, None] * drift
             + np.cumsum(rng.randn(T, m) * 0.01, axis=0)).astype(np.float32)
    xs, us = trollout.linesearch_rollout_plain(
        tm, torch.from_numpy(Q0), torch.from_numpy(u0),
        torch.zeros(T, m, nq + m), torch.zeros(A, T, nq),
        torch.zeros(A, T, m), torch.from_numpy(u_seq).expand(A, T, m),
        torch.full((T, m), -torch.inf), torch.full((T, m), torch.inf),
        None, None)
    want = _jax_warm_chain(jm, Q0, u_seq)
    np.testing.assert_allclose(xs[0, 1:].numpy(), want, atol=5e-3)
    np.testing.assert_allclose(xs[1, 1:].numpy(), want, atol=5e-3)
    # The arm moves the ball: the contacts are engaged.
    assert np.abs(want[-1, :3] - Q0[:3]).max() > 1e-3


@pytest.fixture(scope="module")
def rollout_shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the CPU emulation of the kernels")
    from irs_mpc_torch.ops import _nvcc
    from irs_mpc_torch.tools import cpu_shim
    return cpu_shim.build_all([_nvcc.CSRC / "rollout.cu"],
                              tmp_path_factory.mktemp("shim"))[0]


@pytest.mark.parametrize("swapped, aug, rel, canon", [
    (False, True, True, False),
    (True, False, False, True),
])
def test_rollout_source_on_cpu_shim(rollout_shim, swapped, aug, rel, canon):
    """K4's source on the six-link arm against the plain chain, both
    orders of the pairs, at CHAIN_ATOL."""
    from irs_mpc_torch.tools import cpu_shim
    _, model = _long_arm()
    if swapped:
        model = chip_smoke.swap_pairs(model)
    model = dataclasses.replace(model, canon_warm_duals=canon)
    args = chip_smoke.chain_inputs(model, Q0, A=2, T=4, aug=aug, rel=rel,
                                   device="cpu")
    before = cuda_rollout.LAUNCHES
    with cpu_shim.attached(cuda_rollout, rollout_shim):
        xs, us = cuda_rollout.linesearch_rollout_cuda(model, **args)
    assert cuda_rollout.LAUNCHES == before + 1
    xr, ur = trollout.linesearch_rollout_plain(model, **args)
    assert bool(torch.isfinite(xs).all())
    assert (xs - xr).abs().max().item() < chip_smoke.CHAIN_ATOL
    assert (us - ur).abs().max().item() < chip_smoke.CHAIN_ATOL
    assert (xs[:, -1, :3] - xs[:, 0, :3]).abs().max().item() > 1e-4


def test_link_table_past_its_records_raises(rollout_shim):
    """An arm past the link table's records (here 65 links over one joint)
    is refused by the wrapper, never run on the plain chain instead."""
    from irs_mpc_torch.tools import cpu_shim
    _, tm = _long_arm()
    arm = dataclasses.replace(tm.bodies[1], link_lengths=(0.01,) * 65,
                              joint_idx=(3,) * 65)
    tm = dataclasses.replace(tm, bodies=(tm.bodies[0], arm) + tm.bodies[2:])
    args = chip_smoke.chain_inputs(tm, Q0, A=1, T=2, device="cpu")
    with pytest.raises(ValueError, match="link table"):
        trollout.make_consts(tm)
    before = cuda_rollout.LAUNCHES
    with cpu_shim.attached(cuda_rollout, rollout_shim), \
            pytest.raises(ValueError, match="link table"):
        cuda_rollout.linesearch_rollout_cuda(tm, **args)
    assert cuda_rollout.LAUNCHES == before


def test_long_arm_solver_takes_the_whole_chain():
    """The phase-24 configuration: the long arm's solver on the CPU, with
    its whole-chain rollout attached (K4 on the card), two iterations
    from its float32 initial cost."""
    solver, model = chip_smoke.long_arm_solver("cpu")
    assert solver.system.ls_rollout_fn is not None
    solver.iterate(2, verbose=False)
    assert abs(solver.cost_lst[0] - chip_smoke.LONG_ARM_INITIAL) \
        <= 1e-3 * chip_smoke.LONG_ARM_INITIAL
    assert np.isfinite(solver.cost_best)
    assert solver.cost_best <= solver.cost_lst[0]
