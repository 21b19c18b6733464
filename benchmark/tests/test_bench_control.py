"""``correct`` comes out false where it must: the control (the reference
computed in TF32, the precision below the configuration's float32 with
TF32 off, put in the program's place) and each fault a cell can have,
planted under the timed path, each held to the cell's own limits.  On
the CPU at a size a test run holds (the port's plain path); on the card
at the cells' own sizes (``card``)."""
import pytest
import torch

from benchmark import check, control, harness
from benchmark.program import CrossEntropyMethod, IrsMpc, port_irs
from irs_mpc_torch.ops import estimators

torch.set_num_threads(1)
SEED = 2 ** 31 + 4242

# Test sizes: every width of the configuration, a shorter horizon and
# fewer samples or candidates.
SMALL = {
    "box_pushing.zero_order_B": dict(T=16, num_samples=30),
    "planar_hand.zero_order_B": dict(T=12, num_samples=20),
    "planar_hand.cem": dict(T=12),
}


def small(name):
    c = harness.cell(name)
    config = dict(c.config, **SMALL[name])
    if "cem" in config:
        config["cem"] = dict(config["cem"], batch_size=300, n_elite=30)
    mix = dict(c.mix, iterations_per_plan=6)
    return c._replace(config=config, mix=mix)


def run(c):
    return harness.run(c, SEED, 0.5, False, device="cpu")


@pytest.mark.parametrize("name", list(SMALL))
def test_a_sound_run_is_correct(name):
    assert run(small(name))["correct"] is True


@pytest.mark.parametrize("name", list(SMALL))
def test_the_control_is_not_correct(name):
    c = small(name)
    s = harness.set_up(c, SEED, "cpu", False)
    harness.run_window(c, s, SEED, 0.5, False)
    values = check.numbers(c.config, c.mix, s.recorder, "cpu", control=True)
    ok, table = check.judge(values, check.load_limits(name))
    assert not ok, table


def _unchanged_irs(monkeypatch):
    real = IrsMpc._iteration

    def step(self, x_trj, u_trj, it, perturbations=None):
        out = real(self, x_trj, u_trj, it, perturbations)
        nominal = out.lane_costs[-1]
        return out._replace(x=x_trj, u=u_trj, cvec=nominal,
                            best=out.best * 0 + len(out.lane_costs) - 1,
                            lane_costs=nominal.expand_as(out.lane_costs))

    monkeypatch.setattr(IrsMpc, "_iteration", step)


def _unchanged_cem(monkeypatch):
    real = CrossEntropyMethod._step

    def step(self, u_trj, std_trj, prev_x, prev_cost, kept, noise=None):
        out = real(self, u_trj, std_trj, prev_x, prev_cost, kept, noise)
        return out._replace(x=prev_x, u=u_trj, std=std_trj, cost=prev_cost)

    monkeypatch.setattr(CrossEntropyMethod, "_step", step)


def _half_samples(monkeypatch):
    """The least-squares fit over half of each knot's samples."""
    real = estimators._fit_lstsq

    def fit(S, D, damp=0.0):
        half = S.shape[-2] // 2
        return real(S[..., :half, :], D[..., :half, :], damp)

    monkeypatch.setattr(estimators, "_fit_lstsq", fit)


def _half_elites(monkeypatch):
    """The refit mean taken over half of the elites."""
    real = CrossEntropyMethod._step

    def step(self, u_trj, std_trj, prev_x, prev_cost, kept, noise=None):
        out = real(self, u_trj, std_trj, prev_x, prev_cost, kept, noise)
        half = out.elite_idx[:len(out.elite_idx) // 2]
        a = self.params.momentum
        u = (1 - a) * out.cand[half].mean(0) + a * u_trj
        x = self.rollout(u[None])[0]
        return out._replace(u=u, x=x, cost=self.eval_cost(x, u))

    monkeypatch.setattr(CrossEntropyMethod, "_step", step)


def _altered_states(monkeypatch):
    """Every rollout's states moved by 1 cm at the middle knot, where the
    chain produces them."""
    def alter(xs):
        xs = xs.clone()
        xs[..., xs.shape[-2] // 2, :] += 0.01
        return xs

    real_lanes = IrsMpc._rollout_lanes

    def lanes(self, *args):
        xs, us = real_lanes(self, *args)
        return alter(xs), us

    real_rollout = CrossEntropyMethod.rollout

    def rollout(self, u_b):
        return alter(real_rollout(self, u_b))

    monkeypatch.setattr(IrsMpc, "_rollout_lanes", lanes)
    monkeypatch.setattr(CrossEntropyMethod, "rollout", rollout)


FAULTS = [
    ("box_pushing.zero_order_B", _unchanged_irs),
    ("box_pushing.zero_order_B", _half_samples),
    ("box_pushing.zero_order_B", _altered_states),
    ("planar_hand.zero_order_B", _unchanged_irs),
    ("planar_hand.zero_order_B", _half_samples),
    ("planar_hand.zero_order_B", _altered_states),
    ("planar_hand.cem", _unchanged_cem),
    ("planar_hand.cem", _half_elites),
    ("planar_hand.cem", _altered_states),
]


@pytest.mark.parametrize("name, fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    r = run(small(name))
    assert r["correct"] is False, r["check"]


def _late(monkeypatch, alter):
    """From its second iteration on, a plan's iterations go through
    ``alter(it)``; only first iterations count as resolved, so the
    reference recomputes none of the altered ones whole."""
    real = IrsMpc._iteration
    now = {}

    def step(self, x_trj, u_trj, it, perturbations=None):
        now["it"] = int(it)
        return real(self, x_trj, u_trj, it, perturbations)

    monkeypatch.setattr(IrsMpc, "_iteration", step)
    monkeypatch.setattr(check, "resolved",
                        lambda config, mix: lambda it: it == 1)
    alter(monkeypatch, lambda: now["it"] >= 2)


def _late_lqr_plan(monkeypatch):
    """The boxed LQR's planned inputs 2 cm off in unresolved iterations."""
    def alter(monkeypatch, late):
        real = port_irs.admm_ops.solve_boxed_tvlqr

        def solve(*args, **kwargs):
            sol = real(*args, **kwargs)
            return sol._replace(u_trj=sol.u_trj + 0.02) if late() else sol

        monkeypatch.setattr(port_irs.admm_ops, "solve_boxed_tvlqr", solve)
    _late(monkeypatch, alter)


def _late_nominal_steps(monkeypatch):
    """The nominal's contact steps 1 mm off in unresolved iterations."""
    def alter(monkeypatch, late):
        real = port_irs.estimate_tv_matrices_fnom

        def estimate(*args, **kwargs):
            tv, f_nom = real(*args, **kwargs)
            return (tv, f_nom + 1e-3) if late() else (tv, f_nom)

        monkeypatch.setattr(port_irs, "estimate_tv_matrices_fnom", estimate)
    _late(monkeypatch, alter)


LATE = [(n, f) for n in ("box_pushing.zero_order_B",
                         "planar_hand.zero_order_B")
        for f in (_late_lqr_plan, _late_nominal_steps)]


@pytest.mark.parametrize("name, fault", LATE,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in LATE])
def test_a_fault_in_an_unresolved_iteration_is_not_correct(name, fault,
                                                           monkeypatch):
    """The parts the reference checks on the program's own linearisation
    catch a fault where no whole iteration is recomputed."""
    fault(monkeypatch)
    r = run(small(name))
    number = ("lqr_lane_cost_gap" if fault is _late_lqr_plan
              else "fnom_gap")
    assert r["check"][number]["value"] > r["check"][number]["limit"], \
        r["check"]


@pytest.mark.card
@pytest.mark.parametrize("name", list(SMALL))
def test_the_control_fails_and_sound_runs_pass_on_the_card(name, card):
    """Three seeds at the cell's own size on the card."""
    limits = check.load_limits(name)
    result = control.study(name, [SEED + k for k in range(3)], 3.0, card)
    for entry in result["per_seed"]:
        assert check.judge(check.worst(entry["sound"]), limits)[0]
        assert not check.judge(check.worst(entry["control"]), limits)[0]
