"""The harness: BENCHMARK.json against the contract's shape, everything
found by name (and an unknown name refused), the draws worked out again
as the program draws them, no result without a card, and one cell driven
end to end on the port's plain path on the CPU."""
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import check, harness, problem, readers, tracing, traffic
from benchmark.program import Program

torch.set_num_threads(1)
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()


def test_manifest_has_the_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        reader = harness.metric_reader(m["name"])
        assert reader.SOURCE == m["source"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_what_its_metrics_move(w):
    """setup_s and one other end-to-end metric in every cell, and the
    end-to-end metric that each of its per-layer metrics moves."""
    c = harness.cell(w["name"])
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(m["moves"] in e2e for m in c.per_layer)
    s = harness.Setup(None, None, None, 12.5)
    win = harness.Window(2.0, 8, 168, 0, {}, [], None)
    got = harness.end_to_end(c, s, win)
    assert set(got) == e2e
    for name, v in got.items():
        want = 12.5 if name == "setup_s" else 250.0
        assert v["value"] == want


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_by_name(w):
    c = harness.cell(w["name"])
    assert c.config["name"] == w["config"] and c.mix["name"] == w["traffic"]
    assert check.load_limits(w["name"])
    assert check.reference_model(c.config, check.Arith())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer


@pytest.mark.parametrize("folder, name", [("configs", "no_such_config"),
                                          ("traffic", "no_such_mix"),
                                          ("metrics", "no_such_metric"),
                                          ("configs", "../BENCHMARK")])
def test_an_unknown_name_is_refused(folder, name):
    with pytest.raises(harness.UnknownName):
        if folder == "metrics":
            harness.metric_reader(name)
        else:
            harness.load_json(folder, name)


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.UnknownName):
        harness.cell("box_pushing.no_such_mix")


def test_the_same_seed_gives_the_same_plans():
    mix = harness.load_json("traffic", "zero_order_B")
    a = traffic.plan(mix, 5, 2 ** 31 + 12345, 3)
    b = traffic.plan(mix, 5, 2 ** 31 + 12345, 3)
    c = traffic.plan(mix, 5, 2 ** 31 + 12345, 4)
    assert (a.goal_scale == b.goal_scale).all()
    assert a.solver_seed == b.solver_seed != c.solver_seed
    assert ((0.5 <= a.goal_scale) & (a.goal_scale <= 1.5)).all()


@pytest.mark.parametrize("mix_name", ["zero_order_B", "cem"])
def test_replayed_draws_are_the_programs(mix_name, monkeypatch):
    config = dict(harness.load_json("configs", "planar_hand"), T=6,
                  num_samples=8)
    config["cem"] = dict(config["cem"], batch_size=16, n_elite=4,
                         elite_keep=2)
    mix = harness.load_json("traffic", mix_name)
    plan = traffic.plan(mix, config["nq"], 99, 0)
    solver = Program(config, mix, "cpu").solver(problem.make(config, mix, plan),
                                                plan.solver_seed)
    seen = []
    real = torch.randn

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        if kwargs.get("generator") is solver.generator:
            seen.append(out.clone())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    solver.iterate(3, verbose=False)
    monkeypatch.setattr(torch, "randn", real)
    per = len(check.draw_shapes(config, mix))
    want = check.replay_draws(config, mix, plan.solver_seed, 3, "cpu")
    assert len(seen) == 3 * per
    for got, w in zip(seen[-per:], want):
        assert torch.equal(got, w)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "box_pushing.zero_order_B", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_runs_end_to_end_on_the_plain_path():
    c = harness.cell("box_pushing.zero_order_B")
    c = c._replace(config=dict(c.config, T=20, num_samples=30))
    r = harness.run(c, 2 ** 31 + 7, 1.0, False, device="cpu")
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"plan_ms", "setup_s"}
    assert list(r)[-1] == "check"
    assert set(r["check"]) == {"init_cost_gap", "x_gap", "cost_gap",
                               "lane_cost_gap", "lqr_lane_cost_gap",
                               "fnom_gap"}
    assert r["device"]["platform"] == "cpu"
    json.dumps(r)


def test_a_traced_cell_reads_its_spans_on_the_plain_path(monkeypatch):
    """The traced run's spans and readers on the CPU (no device metric
    is read there: the profiler sees no card)."""
    monkeypatch.setattr(harness, "PROFILED_MARKED", 0)
    monkeypatch.setattr(harness, "PROFILED_SYNCED", 0)
    c = harness.cell("planar_hand.zero_order_B")
    c = c._replace(config=dict(c.config, T=8, num_samples=10))
    s = harness.set_up(c, 5, "cpu", True)
    w = harness.run_window(c, s, 5, 3.0, True)
    layers = {sp.layer for sp in s.spans.records}
    assert {"plan_init", "iteration", "estimation", "lqr", "cost"} <= layers
    metrics = harness.per_layer(c, s, w)
    assert set(metrics) >= {"driver.plan_init_ms", "driver.cost_ms"}
    assert not any(k.startswith("device.") or k.endswith("roofline")
                   for k in metrics)


class _Trace:
    """A finished profiler session that exports a given Chrome trace."""

    def __init__(self, events):
        self.trace = {"traceEvents": events}

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.trace, f)


def test_kernels_go_to_the_range_that_launched_them():
    """A kernel whose device clock reads outside its range (an offset
    between the clocks) is the layer's by its launch's correlation id; a
    kernel without one falls back to its start."""
    def x(cat, name, ts, dur, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    trace = _Trace([
        x("user_annotation", "bench/synced", 0, 1000),
        x("user_annotation", "bench/rollout", 100, 50),
        x("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=7),
        x("kernel", "rollout_kernel", 400, 30, corr=7),
        x("user_annotation", "bench/lqr", 300, 200),
        x("kernel", "admm_kernel", 350, 20),
    ])
    device, ranges = tracing.events(trace)
    block = tracing.split_block(device, ranges, "synced", 1)
    assert readers.device_seconds(block, "rollout") == pytest.approx(30e-6)
    assert readers.device_seconds(block, "lqr") == pytest.approx(20e-6)
