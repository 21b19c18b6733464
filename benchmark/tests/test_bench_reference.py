"""The plain reference of ``benchmark/reference`` held to the port's CPU
path (``device="cpu"``, float32) on the benchmark's own problems, layer by
layer and for whole iterations with the same draws."""
import numpy as np
import pytest
import torch

from benchmark import check, harness, problem, traffic
from benchmark.program import Program
from benchmark.reference.arith import Arith, round_tf32
from benchmark.reference.planner import Planner

torch.set_num_threads(1)
CONFIGS = ("box_pushing", "planar_hand")
F64 = Arith(torch.float64)


def setup(config_name, mix_name="zero_order_B", seed=7, **overrides):
    config = dict(harness.load_json("configs", config_name), **overrides)
    mix = harness.load_json("traffic", mix_name)
    plan = traffic.plan(mix, config["nq"], seed, 0)
    prob = problem.make(config, mix, plan)
    ref = check.reference_model(config, F64)
    return config, mix, plan, prob, Program(config, mix, "cpu"), ref


def states(config, prob, k, seed=0):
    """k states about the start, and inputs about its actuated dofs."""
    rng = np.random.default_rng(seed)
    x = prob.x0 + 0.05 * rng.standard_normal((k, config["nq"]))
    u = x[:, prob.idx_u] + 0.03 * rng.standard_normal((k, config["m"]))
    return (torch.tensor(x, dtype=torch.float32),
            torch.tensor(u, dtype=torch.float32))


@pytest.mark.parametrize("name", CONFIGS)
def test_contact_rows_match_the_port(name):
    config, _, _, prob, prog, ref = setup(name)
    x, _ = states(config, prob, 64)
    G, phi = prog.model.contact_rows(x)
    Gr, phir = ref.contact_rows(F64(x))
    assert ref.rows == config["contact_rows"] == G.shape[-2]
    assert torch.allclose(G.double(), Gr, atol=1e-5)
    assert torch.allclose(phi.double(), phir, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_cold_and_warm_steps_match_the_port(name):
    config, _, _, prob, prog, ref = setup(name)
    x, u = states(config, prob, 64, seed=1)
    got = prog.model.step(x, u)
    want = ref.step(F64(x), F64(u), config["qp_iters"])
    assert (got.double() - want).abs().max() < 2e-4
    T = 12
    u_trj = F64(u[:T]).reshape(T, config["m"])
    got = prog.system.rollout(torch.tensor(prob.x0, dtype=torch.float32),
                              u_trj.float())
    want = ref.rollout(F64(prob.x0), u_trj)
    assert (got.double() - want).abs().max() < 1e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_exact_jacobian_matches_the_port(name):
    config, _, _, prob, prog, ref = setup(name)
    x, u = states(config, prob, 8, seed=2)
    got = prog.system.jacobian_xu_batch(x, u).double()
    _, want = ref.jacobian(F64(x), F64(u))
    assert ((got - want).abs().max() / want.abs().max()) < 1e-3


@pytest.mark.parametrize("name, mode", [("box_pushing", "zero_order_B"),
                                        ("planar_hand", "zero_order_B"),
                                        ("box_pushing", "exact")])
def test_an_iteration_matches_the_port_on_the_same_draws(name, mode):
    config, mix, plan, prob, prog, ref = setup(name, T=20, num_samples=40)
    mix = dict(mix, gradient_mode=mode)
    prog.mix = mix
    solver = prog.solver(prob, plan.solver_seed)
    it = 2
    raw = [torch.randn(s, generator=torch.Generator().manual_seed(3))
           for s in check.draw_shapes(config, mix)]
    pert = None
    if raw:
        sm = config["smoothing"]
        scale = float(traffic.decay(sm["decay"],
                                    torch.tensor(float(it), dtype=torch.float32)))
        pert = (raw[0] * np.float32(sm["std_x"]),
                raw[1] * torch.full((config["m"],), sm["std_u"]) * scale)
    got = solver._iteration(solver.x_trj, solver.u_trj, it, pert)
    _, lanes = Planner(ref, config, prob).irs_iteration(
        mode, F64(solver.x_trj), F64(solver.u_trj), it, raw)
    nominal = lanes.costs[-1, 0]
    gap = (got.lane_costs.double() - lanes.costs).abs().max() / nominal
    assert gap < 1e-3
    x_gap = (got.x.double() - lanes.xs[int(got.best)]).abs().max()
    assert x_gap < 1e-2


def test_a_cem_step_matches_the_port_on_the_same_draw():
    config, mix, plan, prob, prog, ref = setup(
        "planar_hand", "cem", T=20,
        cem=dict(harness.load_json("configs", "planar_hand")["cem"],
                 batch_size=200, n_elite=20))
    solver = prog.solver(prob, plan.solver_seed)
    noise = torch.randn((200, 20, config["m"]),
                        generator=torch.Generator().manual_seed(4))
    cost = torch.tensor(solver.cost)
    got = solver._step(solver.u_trj, solver.std_trj, solver.x_trj, cost,
                       solver.kept, noise=noise)
    want = Planner(ref, config, prob).cem_step(
        F64(solver.u_trj), F64(solver.std_trj), F64(solver.x_trj),
        F64(cost), F64(solver.kept), noise)
    assert (check._rel(got.costs, want.costs, want.costs).max() < 1e-2)
    assert check._rel(got.cost, want.cost, want.cost) < 1e-4
    assert (got.x.double() - want.x).abs().max() < 1e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_the_start_matches_the_constructor(name):
    config, _, plan, prob, prog, ref = setup(name)
    solver = prog.solver(prob, plan.solver_seed)
    x, cost = Planner(ref, config, prob).start(F64(prob.u_init))
    assert (solver.x_trj.double() - x).abs().max() < 1e-4
    assert abs(solver.cost - cost.item()) / cost.item() < 1e-5


def test_tf32_rounds_to_ten_mantissa_bits():
    one = torch.tensor([1.0], dtype=torch.float32)
    assert round_tf32(one + 2.0 ** -12).item() == 1.0
    assert round_tf32(one + 2.0 ** -11).item() == 1.0 + 2.0 ** -10
    assert round_tf32(-(one + 2.0 ** -11)).item() == -(1.0 + 2.0 ** -10)
    inf = torch.tensor([float("inf"), float("nan")])
    out = round_tf32(inf)
    assert out[0].item() == float("inf") and out[1].isnan()
