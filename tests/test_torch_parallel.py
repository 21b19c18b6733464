"""Port parity: the mesh-sharded estimation of irs_mpc_torch
(``parallel/sharded.py``, ``parallel/multihost.py``), on the CPU.

Every cell takes its slice of the single-device estimator's own draws, so
the sharded estimate equals the single-device one up to the order of
summation: atol 1e-5 for the five modes on an in-process 2 x 2 mesh of CPU
cells, and bitwise determinism.  Exact mode, which draws nothing, is also
held against the JAX package's sharded estimator on its 4 x 2 mesh of
virtual CPU devices (atol 1e-5), with the knots padded (T=13 on 2 knot
shards).  One test starts two processes of this file

    python tests/test_torch_parallel.py --child RANK WORLD INIT_FILE OUT

that join a gloo group through ``multihost.initialize`` and estimate on
the (2, 2) ``pod_mesh``, whose sample reduction crosses the process
boundary; both must agree with each other and with the in-process mesh,
and so must a short solver run on that mesh.  The pendulum solver on a
mesh stays within 5 % of the single-device run
(``tests/test_parallel.py:67-85``).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import irs_mpc_torch as tmpc  # noqa: E402
from irs_mpc_torch.ops.estimators import estimate_tv_matrices  # noqa: E402
from irs_mpc_torch.parallel import multihost, sharded  # noqa: E402

MODES = ("exact", "first_order", "zero_order", "zero_order_B",
         "zero_order_AB")


def _nominal(T=20, system=None):
    system = system or tmpc.make_pendulum(0.05)
    u = torch.full((T, system.dim_u), 0.1)
    return system, system.rollout(torch.zeros(system.dim_x), u), u


def _both(system, mode, x, u, cfg, mesh, seed=0):
    """(sharded, single-device) estimates from the same generator seed."""
    got = tmpc.sharded_estimate_tv_matrices(
        system, mode, x, u, torch.Generator().manual_seed(seed), 1, cfg,
        mesh)
    want = estimate_tv_matrices(system, mode, x, u,
                                torch.Generator().manual_seed(seed), 1, cfg)
    return got, want


@pytest.mark.parametrize("mode", MODES)
def test_sharded_estimation_equals_single_device(mode):
    system, x, u = _nominal()
    cfg = tmpc.SmoothingConfig(num_samples=400, std_x=0.3, std_u=0.3)
    got, want = _both(system, mode, x, u, cfg, tmpc.make_mesh(2, 2, "cpu"))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_sharded_contact_and_first_order_A_source():
    """Box pushing's contact step inside the cells (zero_order_B), and a
    system whose df/dx depends on u, for A from averaged first-order
    Jacobians (``zero_order_B_A_source="first_order"``), on a 3 x 2 mesh
    with 64 samples (uneven sample shards)."""
    model = tmpc.make_box_pushing()
    x0 = torch.tensor([0., 0.5, 0., 0., -0.12])
    u = x0[3:5].expand(4, 2).clone()
    system = model.system()
    x = system.rollout(x0, u)
    cfg = tmpc.SmoothingConfig(num_samples=64, std_x=1e-3, std_u=0.1,
                               decay=lambda it: 1.0, decay_std_x=False)
    mesh = tmpc.make_mesh(3, 2, "cpu")
    got, want = _both(system, "zero_order_B", x, u, cfg, mesh)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert float(got.B[:, 3:].abs().mean()) > 0.2

    def step(x, u):
        return x + 0.1 * torch.tanh(x * u[..., :1] + x.flip(-1) * u[..., 1:])

    mult = tmpc.System(name="mult_ctl", dim_x=3, dim_u=2, h=0.1, step=step)
    u = torch.tensor([0.5, 0.2]).expand(20, 2).clone()
    x = mult.rollout(0.1 * torch.arange(3.0), u)
    cfg = tmpc.SmoothingConfig(num_samples=64, std_x=0.3, std_u=0.5,
                               zero_order_B_A_source="first_order")
    got, want = _both(mult, "zero_order_B", x, u, cfg, mesh)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    exact_A = mult.jacobian_xu_batch(x[:-1], u)[:, :, :3]
    assert not np.allclose(got.A.numpy(), exact_A.numpy(), atol=1e-4)


def test_knot_padding_and_exact_mode_match_jax_sharded():
    import jax
    import jax.numpy as jnp
    import irs_mpc_tpu as jmpc
    from irs_mpc_tpu.parallel import sharded as jsharded
    system, x, u = _nominal(T=13)
    cfg = tmpc.SmoothingConfig(num_samples=80, std_x=0.3, std_u=0.3)
    assert sharded._pad_T(13, 2) == 14
    for mode in ("exact", "zero_order"):
        got, want = _both(system, mode, x, u, cfg,
                          tmpc.make_mesh(4, 2, "cpu"))
        assert got.A.shape == (13, 2, 2)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    jt = jsharded.sharded_estimate_tv_matrices(
        jmpc.make_pendulum(0.05), "exact", jnp.asarray(x.numpy()),
        jnp.asarray(u.numpy()), jax.random.PRNGKey(0), 1.0,
        jmpc.SmoothingConfig(num_samples=80), jsharded.make_mesh(4, 2))
    got, _ = _both(system, "exact", x, u, cfg, tmpc.make_mesh(4, 2, "cpu"))
    for a, b in zip(got, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_sharded_estimation_deterministic():
    system, x, u = _nominal()
    cfg = tmpc.SmoothingConfig(num_samples=400, std_x=0.3, std_u=0.3)
    mesh = tmpc.make_mesh(4, 1, "cpu")
    a, _ = _both(system, "zero_order", x, u, cfg, mesh, seed=3)
    b, _ = _both(system, "zero_order", x, u, cfg, mesh, seed=3)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.numpy(), q.numpy())


def test_mesh_construction_and_multihost_helpers_single_process():
    multihost.initialize()              # no address, no env: alone
    assert not torch.distributed.is_initialized()
    mesh = multihost.pod_mesh(knot_shards=2, local_devices=["cpu"] * 8)
    assert mesh.shape == {"sample": 4, "knot": 2} and not mesh.distributed
    assert multihost.is_coordinator()
    assert tmpc.default_mesh(["cpu"] * 8).shape == {"sample": 2, "knot": 4}
    assert tmpc.default_mesh(["cpu"] * 2).shape == {"sample": 2, "knot": 1}
    with pytest.raises(ValueError):
        tmpc.make_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        multihost.pod_mesh(knot_shards=3, local_devices=["cpu"] * 4)


def _pendulum_params(T, S, **kw):
    return tmpc.IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode="zero_order",
        smoothing=tmpc.SmoothingConfig(num_samples=S, std_x=1.0, std_u=1.0),
        **kw)


def test_full_solver_on_mesh_converges():
    params = _pendulum_params(100, 800, mesh=tmpc.make_mesh(2, 2, "cpu"))
    s = tmpc.IrsMpc(tmpc.make_pendulum(0.05), params, device="cpu")
    s.iterate(8, verbose=False)
    ref = tmpc.IrsMpc(tmpc.make_pendulum(0.05),
                      dataclasses.replace(params, mesh=None), device="cpu")
    ref.iterate(8, verbose=False)
    assert abs(s.cost - ref.cost) / ref.cost < 0.05


# The two-process run: the estimate and a short solver run on the mesh.
CHILD_T, CHILD_S, CHILD_SEED = 12, 64, 7


def _child_work(mesh):
    system = tmpc.make_pendulum(0.05)
    rng = np.random.RandomState(0)
    u = torch.from_numpy((0.5 * rng.randn(CHILD_T, 1)).astype(np.float32))
    x = system.rollout(torch.zeros(2), u)
    cfg = tmpc.SmoothingConfig(num_samples=CHILD_S, std_u=0.2, std_x=0.2)
    tv = tmpc.sharded_estimate_tv_matrices(
        system, "zero_order", x, u, torch.Generator().manual_seed(CHILD_SEED),
        1, cfg, mesh)
    s = tmpc.IrsMpc(system, _pendulum_params(20, CHILD_S, mesh=mesh),
                    device="cpu")
    s.iterate(2, verbose=False)
    return dict(A=tv.A.numpy(), B=tv.B.numpy(), c=tv.c.numpy(),
                costs=np.asarray(s.cost_lst))


def _child(rank, world, init_file, out):
    multihost.initialize(f"file://{init_file}", world_size=world, rank=rank,
                         backend="gloo")
    mesh = multihost.pod_mesh(knot_shards=2, local_devices=["cpu", "cpu"])
    assert mesh.distributed and mesh.shape == {"sample": 2, "knot": 2}
    assert multihost.is_coordinator() == (rank == 0)
    np.savez(f"{out}.{rank}.npz", **_child_work(mesh))
    torch.distributed.destroy_process_group()


def test_two_process_gloo_mesh_equals_in_process(tmp_path):
    init, out = tmp_path / "rendezvous", tmp_path / "out"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--child", str(rank), "2", str(init),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"child failed:\n{log}"
    r0, r1 = (np.load(f"{out}.{rank}.npz") for rank in range(2))
    want = _child_work(tmpc.make_mesh(2, 2, "cpu"))
    for key in ("A", "B", "c", "costs"):
        np.testing.assert_array_equal(r0[key], r1[key])
        np.testing.assert_allclose(r0[key], want[key], rtol=1e-5,
                                   atol=1e-5)


if __name__ == "__main__" and "--child" in sys.argv:
    rank, world, init_file, out = sys.argv[sys.argv.index("--child") + 1:]
    _child(int(rank), int(world), init_file, out)
