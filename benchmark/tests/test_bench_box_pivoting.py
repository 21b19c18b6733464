"""Box pivoting's plain reference (``reference/box_pivoting.py``) held to
the port's CPU path (``device="cpu"``, float32) on the problems the
benchmark's generator makes from ``configs/box_pivoting.json``: the 18
contact rows (the ground's and the wall's box corners, then the hand),
cold and warm steps with the canonical dual carry, an iteration on the
same draws and the constructor's start; the same rows, a cold step and a
canonical warm chain again in float64 on both sides; ``correct`` on a
small run, against the TF32 control and a fault in the constructor's
start, held to the cell's limits (on the card at the cell's own size,
``card``); and what the reference loads."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, control, harness, problem, traffic
from benchmark.program import Program
from benchmark.reference.arith import Arith
from benchmark.reference.box_pivoting import Model, corners
from benchmark.reference.planner import Planner
from irs_mpc_torch import make_box_pivoting
from irs_mpc_torch.models.base import System

torch.set_num_threads(1)
F64 = Arith(torch.float64)


def setup(seed=7, **overrides):
    config = dict(harness.load_json("configs", "box_pivoting"), **overrides)
    mix = harness.load_json("traffic", "zero_order_B")
    plan = traffic.plan(mix, config["nq"], seed, 0)
    prob = problem.make(config, mix, plan)
    ref = check.reference_model(config, F64)
    return config, mix, plan, prob, Program(config, mix, "cpu"), ref


def states(config, prob, k, seed=0):
    """k states about the start, and inputs about the hand."""
    rng = np.random.default_rng(seed)
    x = prob.x0 + 0.05 * rng.standard_normal((k, config["nq"]))
    u = x[:, prob.idx_u] + 0.03 * rng.standard_normal((k, config["m"]))
    return (torch.tensor(x, dtype=torch.float32),
            torch.tensor(u, dtype=torch.float32))


def test_contact_rows_and_corners_match_the_port():
    config, _, _, prob, prog, ref = setup()
    x, _ = states(config, prob, 64)
    G, phi = prog.model.contact_rows(x)
    Gr, phir = ref.contact_rows(F64(x))
    assert ref.rows == config["contact_rows"] == G.shape[-2] == 18
    assert torch.allclose(G.double(), Gr, atol=1e-5)
    assert torch.allclose(phi.double(), phir, atol=1e-6)
    pts = corners(F64(x[:, :2]), (0.5, 0.5), F64(x[:, 2]))
    assert torch.allclose(phir[:, 0:8:2], pts[..., 1])            # ground
    assert torch.allclose(phir[:, 8:16:2], 1.0 - pts[..., 0])     # wall


def test_cold_and_warm_steps_match_the_port():
    """A cold step at the full PDIP count, and a 12-knot warm chain under
    a push into the box, whose carried duals are canonical on both
    sides."""
    config, _, _, prob, prog, ref = setup()
    x, u = states(config, prob, 64, seed=1)
    got = prog.model.step(x, u)
    want = ref.step(F64(x), F64(u), config["qp_iters"])
    assert (got.double() - want).abs().max() < 2e-4
    T = 12
    push = np.linspace(0.0, 0.3, T)[:, None] * np.array([1.0, -0.5])
    u_trj = F64(prob.x0[prob.idx_u] + push)
    got = prog.system.rollout(torch.tensor(prob.x0, dtype=torch.float32),
                              u_trj.float())
    want = ref.rollout(F64(prob.x0), u_trj)
    assert (want[-1, :3] - want[0, :3]).abs().max() > 1e-3
    assert (got.double() - want).abs().max() < 1e-3
    carry = ref.carry0()
    for t in range(T):
        _, carry = ref.step_warm(want[t], u_trj[t], carry)
        assert torch.equal(carry[1][0::2], carry[1][1::2])


@pytest.mark.parametrize("it", [1, 2])
def test_an_iteration_matches_the_port_on_the_same_draws(it):
    config, mix, plan, prob, prog, ref = setup(T=12, num_samples=20)
    solver = prog.solver(prob, plan.solver_seed)
    raw = [torch.randn(s, generator=torch.Generator().manual_seed(3))
           for s in check.draw_shapes(config, mix)]
    sm = config["smoothing"]
    scale = float(traffic.decay(sm["decay"],
                                torch.tensor(float(it), dtype=torch.float32)))
    pert = (raw[0] * np.float32(sm["std_x"]),
            raw[1] * torch.full((config["m"],), sm["std_u"]) * scale)
    got = solver._iteration(solver.x_trj, solver.u_trj, it, pert)
    _, lanes = Planner(ref, config, prob).irs_iteration(
        "zero_order_B", F64(solver.x_trj), F64(solver.u_trj), it, raw)
    gap = (got.lane_costs.double() - lanes.costs).abs().max() \
        / lanes.costs[-1, 0]
    assert gap < 1e-3
    assert (got.x.double() - lanes.xs[int(got.best)]).abs().max() < 1e-2


def test_the_start_matches_the_constructor():
    config, _, plan, prob, prog, ref = setup()
    solver = prog.solver(prob, plan.solver_seed)
    x, cost = Planner(ref, config, prob).start(F64(prob.u_init))
    assert (solver.x_trj.double() - x).abs().max() < 1e-4
    assert abs(solver.cost - cost.item()) / cost.item() < 1e-5


# ---------------------------------------------------------------------------
# ``correct`` on the cell's limits
# ---------------------------------------------------------------------------

CELL = "box_pivoting.zero_order_B"
SEED = 2 ** 31 + 4242


def small():
    """The cell at a size a test run holds: every width, a 12-knot
    horizon, 20 samples and 6 iterations a plan."""
    c = harness.cell(CELL)
    return c._replace(config=dict(c.config, T=12, num_samples=20),
                      mix=dict(c.mix, iterations_per_plan=6))


def test_a_small_sound_run_is_correct():
    r = harness.run(small(), SEED, 0.5, False, device="cpu")
    assert r["correct"] is True, r["check"]


def test_the_control_is_not_correct():
    c = small()
    s = harness.set_up(c, SEED, "cpu", False)
    harness.run_window(c, s, SEED, 0.5, False)
    values = check.numbers(c.config, c.mix, s.recorder, "cpu", control=True)
    ok, table = check.judge(values, check.load_limits(CELL))
    assert not ok, table


def test_a_moved_start_is_not_correct(monkeypatch):
    """Every open-loop chain's states, the constructor's start among
    them, moved by 1 cm at the middle knot."""
    real = System.rollout

    def rollout(self, x0, u_trj):
        xs = real(self, x0, u_trj).clone()
        xs[..., xs.shape[-2] // 2, :] += 0.01
        return xs

    monkeypatch.setattr(System, "rollout", rollout)
    r = harness.run(small(), SEED, 0.5, False, device="cpu")
    assert r["correct"] is False, r["check"]
    assert r["check"]["init_cost_gap"]["value"] \
        > r["check"]["init_cost_gap"]["limit"]


@pytest.mark.card
def test_the_control_fails_and_sound_runs_pass_on_the_card(card):
    """Three seeds at the cell's own size on the card."""
    limits = check.load_limits(CELL)
    result = control.study(CELL, [SEED + k for k in range(3)], 3.0, card)
    for entry in result["per_seed"]:
        assert check.judge(check.worst(entry["sound"]), limits)[0]
        assert not check.judge(check.worst(entry["control"]), limits)[0]


# ---------------------------------------------------------------------------
# The port in float64 against the reference, and what the reference loads
# ---------------------------------------------------------------------------

CONFIG = harness.load_json("configs", "box_pivoting")
X0 = np.array(CONFIG["q0"]["box"] + CONFIG["q0"]["hand"])


def states64(k, seed, spread=0.05):
    """k states about the start (the box against the wall, on the
    ground) and inputs about the hand, in float64."""
    rng = np.random.default_rng(seed)
    x = X0 + spread * rng.standard_normal((k, 5))
    u = x[:, 3:] + 0.03 * rng.standard_normal((k, 2))
    return torch.tensor(x), torch.tensor(u)


def test_the_18_rows_and_their_order_match_the_port_in_float64():
    port, ref = make_box_pivoting(**CONFIG["factory_args"]), Model(CONFIG, F64)
    assert port.n_constraint_rows() == ref.rows == CONFIG["contact_rows"]
    x, _ = states64(64, 0)
    G, phi = port.contact_rows(x)
    Gr, phir = ref.contact_rows(x)
    assert (G - Gr).abs().max() < 1e-13 and (phi - phir).abs().max() < 1e-13
    # Two rows a contact, the hand's last and the only ones that move the
    # hand's dofs.
    assert torch.equal(phi[:, 0::2], phi[:, 1::2])
    assert torch.equal(G[:, :16, 3:], torch.zeros_like(G[:, :16, 3:]))
    assert (G[:, 16:, 3:].abs().sum((-1, -2)) > 0).all()


def test_a_cold_step_matches_the_port_in_float64():
    port, ref = make_box_pivoting(**CONFIG["factory_args"]), Model(CONFIG, F64)
    x, u = states64(32, 1)
    got = port.step(x, u)
    want = ref.step(x, u, CONFIG["qp_iters"])
    assert (got - want).abs().max() < 1e-10


def test_a_canonical_warm_chain_matches_the_port_in_float64():
    """Twelve knots of the warm chain from the start under a push into
    the box: states and the carried duals, each contact's two the same."""
    port, ref = make_box_pivoting(**CONFIG["factory_args"]), Model(CONFIG, F64)
    assert port.canon_warm_duals
    T = 12
    rng = np.random.default_rng(2)
    push = np.linspace(0.0, 0.3, T)[:, None] * np.array([1.0, -0.5])
    u = torch.tensor(X0[3:] + push + 0.01 * rng.standard_normal((T, 2)))
    x = torch.tensor(X0)
    carry = tuple(t.double() for t in port.ws_init())
    carry_ref = ref.carry0()
    for t in range(T):
        x_ref, carry_ref = ref.step_warm(x, u[t], carry_ref)
        x, carry = port.step_ws(x, u[t], carry)
        assert (x - x_ref).abs().max() < 1e-10
        assert (carry[1] - carry_ref[1]).abs().max() \
            < 1e-8 * (1.0 + carry_ref[1].abs().max())
        assert torch.equal(carry[1][0::2], carry[1][1::2])
    assert (x[:3] - torch.tensor(X0[:3])).abs().max() > 1e-3   # it moved


def test_the_reference_imports_nothing_of_the_port():
    code = (f"import json, sys; sys.path.insert(0, {str(harness.ROOT)!r})\n"
            "import benchmark.reference.box_pivoting\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "irs_mpc_tpu",
                        "irs_mpc_torch", "chip_smoke"}
