"""Port parity: the analytic example drivers of ``irs_mpc_torch/examples/``
whose configurations no other test holds, against the JAX package's
``examples/`` on the CPU: the bicycle to its easy and hard goals in its
three modes, the opaque-simulator quadrotor and the quadrotor's CEM.  Each
carries the JAX driver's parameters and starts from the JAX package's
initial cost at rtol 1e-4 (the CEM at rtol 1e-5 of the float32 value the
curve runner holds).  The opaque quadrotor's exact Jacobian is exactly
zero, as its driver asserts.

    python tests/test_torch_examples.py --jax-seeds 8 curve[,curve...]

prints the JAX package's best over seeds 0-7 on the CPU, at the driver's
budget, for the curves whose best the random stream may decide (``python
-m irs_mpc_torch.tools.probe_curve_seeds`` prints the port's), and

    python tests/test_torch_examples.py --inject curve iterations

runs the JAX package's iterations of a curve's solver and, at each, the
port's iteration from the JAX package's state with its draws injected,
and prints both costs and the largest difference of the accepted
trajectories.
"""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import bicycle as jbike  # noqa: E402
import irs_mpc_tpu as jmpc  # noqa: E402
import quadrotor as jquad  # noqa: E402
import quadrotor_opaque as jopaque  # noqa: E402
from irs_mpc_tpu.solvers import cem as jcem  # noqa: E402
from irs_mpc_torch import IrsMpc, convert, make_bicycle  # noqa: E402
from irs_mpc_torch.examples import (bicycle, quadrotor,  # noqa: E402
                                    quadrotor_opaque)
from irs_mpc_torch.examples.run_all import RULES  # noqa: E402


def _assert_same_params(jp, tp):
    for f in dataclasses.fields(tp):
        if f.name == "smoothing":
            continue
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(b, np.ndarray):
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for f in ("num_samples", "std_x", "std_u", "decay_std_x"):
        assert np.all(np.asarray(getattr(jp.smoothing, f))
                      == np.asarray(getattr(tp.smoothing, f))), f
    for it in (1, 2, 5):
        assert float(tp.smoothing.decay(torch.tensor(float(it)))) \
            == pytest.approx(float(jp.smoothing.decay(
                jnp.asarray(float(it)))), rel=1e-6)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("mode", bicycle.MODES)
def test_bicycle_is_the_example(mode, hard):
    jp, tp = jbike.build_params(mode, hard), bicycle.build_params(mode, hard)
    _assert_same_params(jp, tp)
    js = jmpc.IrsMpc(jmpc.make_bicycle(0.1), jp)
    ts = IrsMpc(make_bicycle(0.1), tp, device="cpu")
    np.testing.assert_allclose(ts.cost, float(js.cost), rtol=1e-4)


def test_quadrotor_opaque_is_the_example():
    jp = jquad.build_params("zero_order")
    _assert_same_params(jp, quadrotor.build_params("zero_order"))
    js = jmpc.IrsMpc(jopaque.make_opaque_quadrotor(), jp)
    ts = IrsMpc(quadrotor_opaque.make_opaque_quadrotor(),
                quadrotor.build_params("zero_order"), device="cpu")
    np.testing.assert_allclose(ts.cost, float(js.cost), rtol=1e-4)
    # The RK4 simulator's steps themselves, on a batch of random states.
    rng = np.random.RandomState(0)
    x = (0.1 * rng.randn(4, 12)).astype(np.float32)
    u = (2.0 + 0.1 * rng.randn(4, 4)).astype(np.float32)
    want = np.stack([np.asarray(js.system.step(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(x, u)])
    got = ts.system.step(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_quadrotor_opaque_jacobian_is_exactly_zero():
    system = quadrotor_opaque.make_opaque_quadrotor()
    x = torch.full((12,), 0.1)
    u = torch.full((4,), 2.0)
    assert torch.count_nonzero(system.jacobian_xu(x, u)) == 0
    batch = system.jacobian_xu_batch(x.repeat(3, 1), u.repeat(3, 1))
    assert batch.shape == (3, 12, 16) and torch.count_nonzero(batch) == 0
    # The step behind the wall still moves the state.
    assert not torch.equal(system.step(x[None], u[None])[0], x)


def _jax_quadrotor_cem(T=200):
    """``examples/quadrotor.py:53-78`` (built inline there)."""
    return jcem.CrossEntropyMethod(jmpc.make_quadrotor(0.05), jcem.CemParams(
        Q=1.0 * np.diag([10.] * 6 + [0.] * 6),
        Qd=10.0 * np.diag([10.] * 6 + [1.] * 6), R=np.eye(4),
        x0=np.zeros(12), xd_trj=jquad.helix_xd(T),
        u_trj_init=np.tile([2.0] * 4, (T, 1)), n_elite=160,
        batch_size=16000, initial_std=np.ones(4) * 0.02, noise_beta=0.5,
        momentum=0.1, elite_keep=20,
        u_bounds_abs=np.array([np.zeros(4), 4.0 * np.ones(4)])))


def test_quadrotor_cem_is_the_example():
    jc = _jax_quadrotor_cem()
    tc = quadrotor.build_cem_solver(device="cpu")
    want = convert.cem_params_from_jax(jc.params)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f.name), np.float64),
            np.asarray(getattr(tc.params, f.name), np.float64),
            err_msg=f.name)
    np.testing.assert_allclose(tc.cost, float(jc.cost), rtol=1e-5)
    np.testing.assert_allclose(float(jc.cost), RULES["quadrotor_cem"].initial,
                               rtol=1e-5)


@pytest.mark.parametrize("hard", [False, True])
def test_bicycle_cem_starts_from_the_runners_float32_value(hard):
    jc = jbike.build_cem_solver(hard)
    tc = bicycle.build_cem_solver(hard, device="cpu")
    np.testing.assert_allclose(tc.cost, float(jc.cost), rtol=1e-5)
    name = f"bicycle_{'hard' if hard else 'easy'}_cem"
    np.testing.assert_allclose(float(jc.cost), RULES[name].initial,
                               rtol=1e-5)


def _jax_seeded(build, iterations):
    """The JAX package's solver of ``build()``, reseeded, at the driver's
    budget: (seed) -> its best."""
    def best(seed):
        solver = build()
        solver = type(solver)(solver.system, dataclasses.replace(
            solver.params, seed=seed))
        solver.iterate(iterations, verbose=False)
        return float(solver.cost_best)
    return best


def _jax_and_port(curve):
    """The JAX package's solver of an injected curve and the port's, both
    as the drivers build them (the port's on the CPU)."""
    import box_pivoting as jpiv
    import planar_hand_second_order as jhand2
    import planar_hand_spin as jspin
    from irs_mpc_torch.examples import (box_pivoting,
                                        planar_hand_second_order,
                                        planar_hand_spin)
    if curve == "bicycle_easy_zero_order":
        return (jmpc.IrsMpc(jmpc.make_bicycle(0.1),
                            jbike.build_params("zero_order")),
                IrsMpc(make_bicycle(0.1), bicycle.build_params("zero_order"),
                       device="cpu"))
    if curve == "box_pivoting_zero_order":
        return (jpiv.build_solver(gradient_mode="zero_order_B")[0],
                box_pivoting.build_solver(gradient_mode="zero_order_B",
                                          device="cpu")[0])
    if curve == "planar_hand_second_zero_order_AB":
        return (jhand2.build_solver(gradient_mode="zero_order_AB")[0],
                planar_hand_second_order.build_solver(
                    gradient_mode="zero_order_AB", device="cpu")[0])
    mode = curve[len("planar_hand_spin_"):]
    return (jspin.build_solver(gradient_mode=mode)[0],
            planar_hand_spin.build_solver(gradient_mode=mode,
                                          device="cpu")[0])


def inject(curve, iterations):
    """Each of the JAX package's first ``iterations`` iterations of
    ``curve`` beside the port's from the same state with the same draws."""
    import jax
    from irs_mpc_tpu.ops.estimators import _sample_perturbations
    js, ts = _jax_and_port(curve)
    p = js.params
    T, S = ts.T, p.smoothing.num_samples
    n, m = ts.system.dim_x, ts.system.dim_u
    x, u, key = js.x_trj, js.u_trj, js.key
    for it in range(1, iterations + 1):
        itf = jnp.asarray(float(it), jnp.float32)
        _, k_est = jax.random.split(key)
        sx, su = p.smoothing.stds(itf, n, m)
        dx, du = jax.vmap(lambda k: _sample_perturbations(k, sx, su, S))(
            jax.random.split(k_est, T))
        jx, ju, key, jcvec = js._iteration_jit(x, u, key, itf)
        step = ts._iteration(torch.from_numpy(np.array(x)),
                             torch.from_numpy(np.array(u)), it,
                             perturbations=(torch.from_numpy(np.array(dx)),
                                            torch.from_numpy(np.array(du))))
        ex = np.abs(step.x.numpy() - np.asarray(jx)).max()
        eu = np.abs(step.u.numpy() - np.asarray(ju)).max()
        print(f"{curve} iteration {it}: cost JAX {float(jcvec[0]):.4f} port "
              f"{float(step.cvec[0]):.4f}; max |x - x_JAX| {ex:.3e}, max "
              f"|u - u_JAX| {eu:.3e}", flush=True)
        x, u = jx, ju


def jax_seed_study(seeds, curves):
    """The JAX package's example solvers for each seed: the best at the
    driver's budget, then each curve's median."""
    import statistics

    import box_pivoting as jpiv
    import box_pushing as jbox
    import planar_hand_second_order as jhand2
    import planar_hand_spin as jspin
    studies = {
        **{f"planar_hand_spin_{m}": _jax_seeded(
            lambda m=m: jspin.build_solver(gradient_mode=m)[0], 21)
           for m in jspin.MODES},
        "box_pivoting_zero_order": _jax_seeded(
            lambda: jpiv.build_solver(gradient_mode="zero_order_B")[0], 10),
        "box_pushing_first_order": _jax_seeded(
            lambda: jbox.build_solver(gradient_mode="first_order")[0], 21),
        "planar_hand_second_zero_order_AB": _jax_seeded(
            lambda: jhand2.build_solver(gradient_mode="zero_order_AB")[0],
            15),
        "bicycle_easy_zero_order": _jax_seeded(
            lambda: jmpc.IrsMpc(jmpc.make_bicycle(0.1),
                                jbike.build_params("zero_order")), 12),
        "bicycle_easy_cem": _jax_seeded(
            lambda: jbike.build_cem_solver(False), 10),
        "quadrotor_cem": _jax_seeded(_jax_quadrotor_cem, 1200),
    }
    for curve in curves:
        bests = []
        for seed in range(seeds):
            bests.append(studies[curve](seed))
            print(f"{curve} seed {seed}: best {bests[-1]:.4f}", flush=True)
        print(f"{curve}: median best {statistics.median(bests):.4f} over "
              f"seeds 0-{seeds - 1}; sorted "
              + " ".join(f"{b:.3f}" for b in sorted(bests))
              + " (JAX, the CPU)", flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    if "--jax-seeds" in sys.argv:
        args = sys.argv[sys.argv.index("--jax-seeds") + 1:]
        jax_seed_study(int(args[0]), args[1].split(","))
    elif "--inject" in sys.argv:
        args = sys.argv[sys.argv.index("--inject") + 1:]
        inject(args[0], int(args[1]))
