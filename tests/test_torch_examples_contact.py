"""Port parity: the contact example drivers of ``irs_mpc_torch/examples/``
whose configurations no other test holds, against the JAX package's
``examples/`` on the CPU: box pushing on the LCP contact model in its
three modes, box pushing's exact mode from the informed guess, the planar
hand's spin task in its four modes and its CEM, and the second-order spin
CEM's initial cost.  Each carries the JAX
driver's model and parameters, and starts from the JAX package's initial
cost at rtol 1e-4 (the CEM's float32 value at rtol 1e-5, the value the
curve runner holds).
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

import box_pushing as jbox  # noqa: E402
import planar_hand_second_order as jhand2  # noqa: E402
import planar_hand_spin as jspin  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.examples import (box_pushing,  # noqa: E402
                                    planar_hand_second_order,
                                    planar_hand_spin)
from irs_mpc_torch.examples.run_all import RULES  # noqa: E402


def _jax_lcp(mode):
    """``examples/box_pushing.py:117-138``, as its ``main`` builds it."""
    js, jm = jbox.build_solver(gradient_mode=mode, contact_model="lcp")
    if mode == "zero_order_AB":
        p = js.params
        p.decouple_AB = False
        p.smoothing = dataclasses.replace(p.smoothing, std_x=0.1,
                                          decay_std_x=True)
        js = type(js)(js.system, p)
    return js, jm


def _assert_same_configuration(js, jm, ts, tm):
    assert convert.model_from_jax(jm) == tm
    for f in dataclasses.fields(ts.params):
        if f.name in ("smoothing", "estimation_system", "decay"):
            continue
        a, b = getattr(js.params, f.name), getattr(ts.params, f.name)
        if isinstance(b, np.ndarray):
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    jsm, tsm = js.params.smoothing, ts.params.smoothing
    for f in ("num_samples", "std_x", "std_u", "decay_std_x"):
        assert np.all(np.asarray(getattr(jsm, f))
                      == np.asarray(getattr(tsm, f))), f
    for it in (1, 2, 5):
        assert float(tsm.decay(torch.tensor(float(it)))) == pytest.approx(
            float(jsm.decay(jnp.asarray(float(it)))), rel=1e-6)
    assert (js.params.estimation_system is None) == (
        ts.params.estimation_system is None)
    np.testing.assert_allclose(ts.cost, float(js.cost), rtol=1e-4)


@pytest.mark.parametrize("mode", box_pushing.LCP_MODES)
def test_box_pushing_lcp_is_the_example(mode):
    js, jm = _jax_lcp(mode)
    ts, tm = box_pushing.build_lcp_solver(mode, device="cpu")
    assert tm.contact_model == "lcp"
    assert ts.system.ls_rollout_fn is None     # K4 refuses the LCP model
    _assert_same_configuration(js, jm, ts, tm)


def test_box_pushing_good_guess_is_the_example():
    js, jm = jbox.build_good_guess_solver()
    ts, tm = box_pushing.build_good_guess_solver(device="cpu")
    _assert_same_configuration(js, jm, ts, tm)
    np.testing.assert_allclose(ts.cost, 136.3897, rtol=1e-4)


@pytest.mark.parametrize("mode", planar_hand_spin.MODES)
def test_planar_hand_spin_is_the_example(mode):
    js, jm = jspin.build_solver(gradient_mode=mode)
    ts, tm = planar_hand_spin.build_solver(gradient_mode=mode, device="cpu")
    _assert_same_configuration(js, jm, ts, tm)


def test_planar_hand_spin_cem_is_the_example():
    jc, jm = jspin.build_cem_solver(T=6, batch_size=20, n_elite=4)
    tc, tm = planar_hand_spin.build_cem_solver(T=6, batch_size=20, n_elite=4,
                                               device="cpu")
    assert convert.model_from_jax(jm) == tm
    want = convert.cem_params_from_jax(jc.params)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f.name), np.float64),
            np.asarray(getattr(tc.params, f.name), np.float64),
            err_msg=f.name)
    np.testing.assert_allclose(tc.cost, float(jc.cost), rtol=1e-5)
    # The full-width search starts from the float32 value the runner holds.
    jc, _ = jspin.build_cem_solver()
    np.testing.assert_allclose(float(jc.cost),
                               RULES["planar_hand_spin_cem"].initial,
                               rtol=1e-5)


def test_spin_second_order_cem_starts_from_the_runners_float32_value():
    """The second-order spin CEM (``examples/planar_hand_second_order.py:
    186-188``): the float32 initial cost of both packages, which the runner
    holds (the committed curve's 132.1029 was recorded on a TPU)."""
    jc, _ = jhand2.build_cem_solver(spin=True, batch_size=20, n_elite=16)
    tc, _ = planar_hand_second_order.build_cem_solver(
        spin=True, batch_size=20, n_elite=16, device="cpu")
    np.testing.assert_allclose(tc.cost, float(jc.cost), rtol=1e-5)
    np.testing.assert_allclose(float(jc.cost),
                               RULES["planar_hand_spin_second_cem"].initial,
                               rtol=1e-5)
