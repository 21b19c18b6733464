"""The planar hand's spin task (``examples/planar_hand_spin.py``): why its
curves are held as the curve runner holds them, on the CPU.

* Its zero-order paths (zero_order_B, zero_order_AB): with the JAX
  iteration's draws injected, each of the port's first three iterations
  equals the JAX package's, from the JAX package's own state at each
  iteration (the cost channels at rtol 1e-5 and atol 1e-4, trajectories
  at atol 1e-4; over 8 iterations ``python tests/test_torch_examples.py
  --inject <curve> 8`` measures 4.6e-6).  So the port has the JAX
  package's descent, and its best differs only by the random stream,
  which in the JAX package alone moves the best out of the committed
  curve's band (``python tests/test_torch_examples.py --jax-seeds 8
  <curve>``).
* Its exact and first_order paths use the exact contact Jacobians: the
  port's float32 Jacobians lie within 1e-4 of its float64 ones, the JAX
  package's float32 ones are not determined (``PERF.md`` §6).
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

import irs_mpc_torch as tmpc  # noqa: E402
import planar_hand_spin as jspin  # noqa: E402
from irs_mpc_tpu.ops.estimators import _sample_perturbations  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402

T, S = 30, 50


@pytest.mark.parametrize("mode", ["zero_order_B", "zero_order_AB"])
def test_injected_iterations_match_jax(mode):
    js, jm = jspin.build_solver(gradient_mode=mode)
    p = js.params
    tm = convert.model_from_jax(jm)
    ts = tmpc.IrsMpc(tm.system(), convert.params_from_jax(
        p, decay=lambda it: 1.0 / it ** 0.5,
        estimation_system=tm.estimation_surrogate()), device="cpu")
    x, u, key = js.x_trj, js.u_trj, js.key
    for it in (1, 2, 3):
        itf = jnp.asarray(float(it), jnp.float32)
        _, k_est = jax.random.split(key)
        sx, su = p.smoothing.stds(itf, jm.nq, jm.dim_u)
        dx, du = jax.vmap(lambda k: _sample_perturbations(k, sx, su, S))(
            jax.random.split(k_est, T))
        jx, ju, key, jcvec = js._iteration_jit(x, u, key, itf)
        step = ts._iteration(torch.from_numpy(np.array(x)),
                             torch.from_numpy(np.array(u)), it,
                             perturbations=(torch.from_numpy(np.array(dx)),
                                            torch.from_numpy(np.array(du))))
        # The total and each channel; a channel of ~1e-3 (the arms' small
        # weights) sums float32 terms of ~1e-5 in another order.
        np.testing.assert_allclose(step.cvec.numpy(), np.asarray(jcvec),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(step.x.numpy(), np.asarray(jx),
                                   atol=1e-4)
        np.testing.assert_allclose(step.u.numpy(), np.asarray(ju),
                                   atol=1e-4)
        x, u = jx, ju


def test_spin_jacobians_are_float64_accurate_where_jax_float32_is_not():
    """Why the spin task's exact and first_order curves are not held to
    the JAX package's: at its initial nominal (30 knots, the ball held
    between the arms) the exact contact Jacobians that those modes use
    are determined by the precision of the QP's implicit-function JVP.
    The port's float32 Jacobians (their JVP solved in float64) lie within
    1e-4 of the port's float64 ones, relative to each knot's largest
    entry (measured 2.0e-6); the JAX package's float32 Jacobians lie off
    them by 9-171 % (median 58 %), so its curves in these modes follow
    its rounding, on its platform."""
    js, jm = jspin.build_solver(gradient_mode="exact")
    x, u = np.asarray(js.x_trj[:-1]), np.asarray(js.u_trj)
    jac = np.asarray(jax.vmap(js.system.jacobian_xu)(jnp.asarray(x),
                                                     jnp.asarray(u)))
    system = convert.model_from_jax(jm).system()
    got = system.jacobian_xu_batch(torch.from_numpy(x),
                                   torch.from_numpy(u)).numpy()
    ref = system.jacobian_xu_batch(torch.from_numpy(x).double(),
                                   torch.from_numpy(u).double()).numpy()
    scale = np.abs(ref).max(axis=(1, 2))
    port = np.abs(got - ref).max(axis=(1, 2)) / scale
    jax_err = np.abs(jac - ref).max(axis=(1, 2)) / scale
    assert port.max() < 1e-4
    assert np.median(jax_err) > 0.05
