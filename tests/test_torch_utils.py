"""Port parity: ``irs_mpc_torch.utils`` against ``tests/test_utils.py``'s
demands of the JAX package's utils, on the CPU: checkpoint resume bit for
bit, the CEM's saved fields and generator state, the config's JSON round
trip, the system registry and its ``contact_model`` override (the LCP
step's boundary layer against the JAX package's at atol 1e-5), the
tracer's report of its phases, the plots and animations (where matplotlib is installed), and that
importing the port loads no matplotlib.
"""
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_torch import (IrsMpc, IrsMpcParams, SmoothingConfig,  # noqa: E402
                           make_box_pushing, make_pendulum)
from irs_mpc_torch.examples import pendulum  # noqa: E402
from irs_mpc_torch.utils.checkpoint import (load_checkpoint,  # noqa: E402
                                            save_checkpoint)
from irs_mpc_torch.utils.config import ExperimentConfig, make_system  # noqa: E402
from irs_mpc_torch.utils import timing  # noqa: E402
from irs_mpc_torch.utils.timing import block_until_ready  # noqa: E402
from irs_mpc_tpu.utils import config as jconfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The boundary-layer probe of tests/test_utils.py:100-117: the hand 0.03
# below the box, commanded 0.03 further toward it.
PROBE_X, PROBE_U = [0., 0.5, 0., 0., -0.13], [0., -0.03]


def _solver(T=50):
    return IrsMpc(make_pendulum(0.05), IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode="zero_order",
        smoothing=SmoothingConfig(num_samples=200, std_x=1.0, std_u=1.0)),
        device="cpu")


def test_checkpoint_resume_bitwise(tmp_path):
    """Resuming from a checkpoint reproduces the uninterrupted run exactly
    (the generator's state and the iteration are part of the state)."""
    a = _solver()
    a.iterate(5, verbose=False)
    b = _solver()
    b.iterate(2, verbose=False)
    ckpt = save_checkpoint(tmp_path / "ck.npz", b)
    c = _solver()
    load_checkpoint(ckpt, c)
    assert c.iter == b.iter and c.cost_lst == b.cost_lst
    c.iterate(3, verbose=False)
    assert torch.equal(c.u_trj, a.u_trj) and torch.equal(c.x_trj, a.x_trj)
    assert c.cost_lst == a.cost_lst and c.cost == a.cost


def test_checkpoint_restores_every_saved_field_of_a_cem(tmp_path):
    cem = pendulum.build_cem_solver(T=40, batch_size=30, n_elite=12,
                                    device="cpu")
    cem.iterate(2, verbose=False)
    ckpt = save_checkpoint(tmp_path / "cem.npz", cem)
    fresh = pendulum.build_cem_solver(T=40, batch_size=30, n_elite=12,
                                      device="cpu")
    load_checkpoint(ckpt, fresh)
    for name in ("u_trj", "x_trj", "u_trj_best", "x_trj_best"):
        got, want = getattr(fresh, name), getattr(cem, name)
        assert got.device == fresh.device and torch.equal(got, want), name
    assert torch.equal(fresh.generator.get_state(), cem.generator.get_state())
    assert (fresh.iter, fresh.cost_lst, fresh.cost, fresh.cost_best) == (
        cem.iter, cem.cost_lst, cem.cost, cem.cost_best)
    # The same draws follow: the restored generator is the saved one.
    assert torch.equal(torch.randn(5, generator=fresh.generator),
                       torch.randn(5, generator=cem.generator))


def test_experiment_config_roundtrip(tmp_path):
    cfg = ExperimentConfig(system="bicycle", T=42, gradient_mode="exact",
                           contact_model="lcp")
    assert ExperimentConfig.from_json(cfg.to_json(tmp_path / "c.json")) == cfg
    # The same fields and defaults as the JAX package's config.
    assert dataclasses.asdict(ExperimentConfig()) == dataclasses.asdict(
        jconfig.ExperimentConfig())


def test_system_registry():
    assert make_system("pendulum", 0.05).dim_x == 2
    assert make_system("box_pushing", 0.1).dim_x == 5
    with pytest.raises(KeyError):
        make_system("nope", 0.1)
    with pytest.raises(ValueError):
        make_system("pendulum", 0.05, contact_model="lcp")
    for name in ("pendulum", "bicycle", "quadrotor", "three_cart",
                 "planar_hand", "box_pivoting", "plate_pickup"):
        want = jconfig.make_system(name, 0.1)
        got = make_system(name, 0.1)
        assert (got.dim_x, got.dim_u, got.h) == (want.dim_x, want.dim_u,
                                                 want.h), name


@pytest.mark.parametrize("contact_model", ["anitescu", "lcp"])
def test_contact_model_override_steps_as_the_jax_package(contact_model):
    """The boundary-layer probe: Anitescu reacts to a gap-closing command,
    the LCP step does not (the gap is still open at the step's start);
    both steps equal the JAX package's at atol 1e-5."""
    got = make_system("box_pushing", 0.1, contact_model=contact_model).step(
        torch.tensor([PROBE_X]), torch.tensor([PROBE_U]))[0].numpy()
    want = np.asarray(jconfig.make_system(
        "box_pushing", 0.1, contact_model=contact_model).step(
            jnp.asarray(PROBE_X, jnp.float32),
            jnp.asarray(PROBE_U, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if contact_model == "lcp":
        assert abs(got[1] - 0.5) < 1e-4
    else:
        assert got[1] > 0.5 + 1e-3


def test_build_system_threads_contact_model():
    step = ExperimentConfig(system="box_pushing", h=0.1,
                            contact_model="lcp").build_system().step
    y = float(step(torch.tensor([PROBE_X]), torch.tensor([PROBE_U]))[0, 1])
    assert abs(y - 0.5) < 1e-4
    assert make_box_pushing().contact_model == "anitescu"


def test_phase_timer():
    """The tracer's report: host ms by span name, with its calls, the
    largest total first; reset empties it."""
    x = torch.ones(3)
    timing.reset()
    with timing.tracing():
        with timing.span("a"):
            pass
        with timing.span("a"):
            block_until_ready({"x": [x, (x,)]})
        with timing.span("b"):
            time.sleep(0.02)
    lines = timing.report().splitlines()
    assert [ln.split()[0] for ln in lines] == ["b", "a"]
    assert "calls     2" in lines[1] and "calls     1" in lines[0]
    assert float(lines[0].split()[2]) >= 20.0
    assert block_until_ready(x) is x           # CPU tensors: nothing to wait
    timing.reset()
    assert timing.records() == [] and timing.report() == ""


def test_viz_smoke(tmp_path):
    pytest.importorskip("matplotlib")
    from irs_mpc_torch.utils.viz import (plot_cost_curves,
                                         plot_phase_trajectories)
    assert plot_cost_curves({"all": [3, 2, 1]}, tmp_path / "c.png").exists()
    assert plot_phase_trajectories(
        [torch.randn(10, 2) for _ in range(3)], tmp_path / "ph.png").exists()


def test_analytic_animation_smoke(tmp_path):
    pytest.importorskip("matplotlib")
    from irs_mpc_torch.utils.viz import animate_analytic_trajectory
    for name, dim in [("pendulum", 2), ("three_cart", 6), ("bicycle", 5),
                      ("quadrotor", 12)]:
        x = torch.cumsum(torch.ones(5, dim) * 0.1, 0)
        p = animate_analytic_trajectory(name, x, tmp_path / f"{name}.gif",
                                        fps=2)
        assert p.exists() and p.stat().st_size > 0


def test_contact_animation_smoke(tmp_path):
    pytest.importorskip("matplotlib")
    from irs_mpc_torch.utils.viz import animate_contact_trajectory
    x_trj = torch.tensor([0., 0.5, 0., 0., -0.2]).repeat(3, 1)
    p = animate_contact_trajectory(make_box_pushing(), x_trj,
                                   tmp_path / "a.gif", fps=2)
    assert p.exists()


def test_importing_the_port_loads_no_matplotlib():
    """The card's machine has no matplotlib: the package, its utils and
    its examples import without it."""
    code = ("import sys, irs_mpc_torch, irs_mpc_torch.utils.viz, "
            "irs_mpc_torch.utils.timing, irs_mpc_torch.utils.checkpoint, "
            "irs_mpc_torch.utils.config, irs_mpc_torch.examples.run_all; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "False"
