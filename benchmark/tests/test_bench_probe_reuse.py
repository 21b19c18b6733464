"""The reader of ``driver.probe_reuse_share`` on made-up records: the
share of the marked plans' top-level ``plan_init`` spans that count
``probe_reused``, 0 where none does, and nothing where the marked plans
hold no constructor of the program."""
import types

import pytest

from benchmark import harness, program_trace, tracing

NS, OFF = 1e9, 5.0


def _at(t):
    """A trace time as the record's ns, 5 s behind."""
    return int((t - OFF) * NS)


def _rec(name, t0, t1, parent=-1, counts=None):
    return types.SimpleNamespace(name=name, t0=_at(t0), t1=_at(t1),
                                 parent=parent, plan=0, counts=counts)


def _run(recs, monkeypatch):
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    ranges = [tracing.Interval("bench/plan_init", 0.09, 0.30),
              tracing.Interval("bench/cost", 0.21, 0.22)]
    block = tracing.Block(tracing.Interval("marked", 0.0, 2.0), [], ranges,
                          2)
    return harness.TraceRun({}, {}, [], block, None, 0)


def _plans(init_counts):
    """One constructor for each entry of ``init_counts`` (the counts of
    its ``plan_init`` span; None: the program left no constructor span),
    with a ``probe`` span where it probed, its cost, then one iteration
    with a nested ``plan_init``-named span that is not a constructor."""
    recs = []
    for k, counts in enumerate(init_counts):
        t = 0.10 + 0.40 * k
        if counts is None:
            recs.append(_rec("iteration", t + 0.22, t + 0.30))
            continue
        recs.append(_rec("plan_init", t, t + 0.20, counts=counts))
        top = len(recs) - 1
        if not (counts or {}).get("probe_reused"):
            recs.append(_rec("probe", t + 0.01, t + 0.05, top))
        recs.append(_rec("cost", t + 0.11, t + 0.12, top))
        recs.append(_rec("iteration", t + 0.22, t + 0.30))
        recs.append(_rec("plan_init", t + 0.23, t + 0.24, len(recs) - 1,
                         {"probe_reused": 1}))
    return recs


READ = harness.metric_reader("driver.probe_reuse_share").read


@pytest.mark.parametrize("counts, share", [
    ([{"probe_reused": 1}, {"probe_reused": 1}], 1.0),
    ([{"probe_reused": 1}, None, {"probe_reused": 1}], 1.0),
    ([{"probe_reused": 1}, {}, None, {"probe_reused": 1}], 2 / 3),
    ([{}, None, {"knots": 60}], 0.0),
    ([None, None], None),
])
def test_the_share_of_constructors_that_reused_the_probe(counts, share,
                                                         monkeypatch):
    """Only top-level ``plan_init`` spans count (a nested span of that
    name does not); constructors that all probed read 0, as the parent
    does; a program that left no constructor span reads nothing."""
    recs = _plans(counts)
    if share is None:
        recs.append(_rec("cost", 0.21, 0.22))
    assert READ(_run(recs, monkeypatch)) == share


def test_the_manifest_lists_the_reader_for_the_irs_cells():
    entry = {m["name"]: m for m in harness.manifest()["per_layer"]}[
        "driver.probe_reuse_share"]
    assert entry["workloads"] == ["box_pushing.zero_order_B",
                                  "planar_hand.zero_order_B"]
    assert entry["moves"] == "plan_ms" and entry["layer"] == "driver"
    assert entry["source"] == READ.__globals__["SOURCE"] == "program_span"
