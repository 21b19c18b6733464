"""The port's curve runner, ``irs_mpc_torch/examples/run_all.py``, on the
CPU: its table of rules on synthetic curves in a temporary directory
(drift of the initial cost and of the best, the one-sided and the
seed-median rules, a driver that raises, the exit code), and the cheapest
whole driver, ``three_cart`` (one curve, 20 iterations), run through
``--check --cpu`` against its committed curve, with ``examples/analysis/``
byte for byte unchanged afterwards.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from irs_mpc_torch.examples import run_all  # noqa: E402
from irs_mpc_torch.examples.common import ANALYSIS_DIR, Curve  # noqa: E402
from irs_mpc_torch.examples.run_all import Rule, check_curve  # noqa: E402

COMMITTED = [100.0, 60.0, 50.0, 52.0]      # best 50, last 52


@pytest.mark.parametrize("costs, rule, drifted", [
    ([100.05, 70.0, 54.0], Rule(), []),
    ([100.2, 70.0, 54.0], Rule(), ["initial"]),
    ([100.0, 70.0, 57.0], Rule(), ["best"]),
    ([100.0, 70.0, 43.0], Rule(), ["best"]),
    ([100.0, 40.0, 30.0], Rule(best="above"), []),
    ([100.0, 70.0, 57.0], Rule(best="above"), ["best"]),
    ([99.0, 58.0], Rule(best="last", initial=99.0), []),
    ([100.0, 58.5], Rule(best="last", initial=99.0), ["initial", "best"]),
    ([100.0, 99.0], Rule(best="below_initial"), []),
    ([100.0, 100.0], Rule(best="below_initial"), ["best"]),
])
def test_rules_on_synthetic_curves(costs, rule, drifted):
    drifts, _ = check_curve(costs, COMMITTED, rule, device="cpu")
    assert [d.split()[0] for d in drifts] == drifted


@pytest.mark.parametrize("other, one_sided, ok", [
    ((51.0, 53.0, 54.0, 90.0), False, True),     # median 53 of 50 +- 12 %
    ((57.0, 58.0, 59.0, 60.0), False, False),    # median 58
    ((20.0, 21.0, 22.0, 23.0), False, False),    # median 22, too low
    ((20.0, 21.0, 22.0, 23.0), True, True),      # from above only
])
def test_median_rule_runs_the_other_seeds(other, one_sided, ok):
    calls = []

    def rerun(seed, device):
        calls.append((seed, device))
        return other[seed - 1]

    rule = Rule(best="median", seeds=tuple(range(5)), reference=50.0,
                one_sided=one_sided, rerun=rerun)
    drifts, held = check_curve([100.0, 70.0, 52.0], COMMITTED, rule, "cpu")
    assert calls == [(seed, "cpu") for seed in range(1, 5)]
    assert held == np.median((52.0,) + other)
    assert (not drifts) == ok


def test_sweep_exit_code_and_summary(tmp_path, capsys):
    analysis = tmp_path / "analysis"
    analysis.mkdir()
    np.savetxt(analysis / "good.csv", COMMITTED)
    np.savetxt(analysis / "bad.csv", COMMITTED)

    def driver(costs):
        def main(out_dir, device, gifs):
            assert device == "cpu" and not gifs
            return [Curve(name, c, 1.0) for name, c in costs.items()]
        return main

    def broken(out_dir, device, gifs):
        raise RuntimeError("a driver that raises")

    good = {"a": driver({"good": [100.0, 51.0]})}
    assert run_all.sweep(good, tmp_path / "out", "cpu", True, analysis,
                         {}) == 0
    assert "CHECK OK" in capsys.readouterr().out
    assert (tmp_path / "out" / "check.json").exists()
    drift = {"a": driver({"good": [100.0, 51.0], "bad": [100.0, 70.0]})}
    assert run_all.sweep(drift, tmp_path / "out", "cpu", True, analysis,
                         {}) == 1
    assert "DRIFT bad" in capsys.readouterr().out
    failing = dict(good, b=broken)
    assert run_all.sweep(failing, tmp_path / "out", "cpu", True, analysis,
                         {}) == 1
    assert "FAILED b" in capsys.readouterr().out


def test_runner_never_writes_the_committed_curves(tmp_path):
    from irs_mpc_torch.examples.common import save_cost_curve
    with pytest.raises(ValueError):
        save_cost_curve("three_cart_zero_order", [1.0, 0.5], ANALYSIS_DIR)


def test_three_cart_through_the_runner_leaves_the_analysis_unchanged(
        tmp_path):
    before = {p.name: p.read_bytes() for p in ANALYSIS_DIR.iterdir()}
    rc = run_all.main(["--check", "--cpu", "--out", str(tmp_path),
                       "three_cart"])
    assert rc == 0
    after = {p.name: p.read_bytes() for p in ANALYSIS_DIR.iterdir()}
    assert after == before
    written = np.loadtxt(Path(tmp_path) / "three_cart_zero_order.csv")
    assert len(written) == 21
    assert not (Path(tmp_path) / "three_cart.gif").exists()
