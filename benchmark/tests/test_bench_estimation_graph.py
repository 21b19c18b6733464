"""The reader of ``estimation.graph_share`` on made-up records: the share
of the marked plans' iteration ``estimation`` spans that count
``est_graph``, 0 where none does, and nothing in a cell without
estimation (CEM)."""
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
    block = tracing.Block(tracing.Interval("marked", 0.0, 1.0), [], ranges,
                          2)
    return harness.TraceRun({}, {}, [], block, None, 0)


def _plan(estimation_counts):
    """A constructor, then one iteration for each entry of
    ``estimation_counts`` (None: no estimation span, as in CEM)."""
    recs = [_rec("plan_init", 0.10, 0.30),
            _rec("cost", 0.21, 0.22, 0),
            _rec("estimation", 0.23, 0.24, 0, {"est_graph": 1})]
    for k, counts in enumerate(estimation_counts):
        t = 0.40 + 0.15 * k
        recs.append(_rec("iteration", t, t + 0.12))
        if counts is not None:
            recs.append(_rec("estimation", t + 0.01, t + 0.05,
                             len(recs) - 1, counts))
    return recs


READ = harness.metric_reader("estimation.graph_share").read


@pytest.mark.parametrize("counts, share", [
    ([{"est_graph": 1}, {"est_graph": 1}], 1.0),
    ([{"est_graph": 1, "est_capture": 1}, {"est_graph": 1}], 1.0),
    ([{"est_graph": 1}, None], 1.0),
    ([None, {"est_graph": 1}, {}, {"knots": 3}], 1 / 3),
    ([{}, {"knots": 3}], 0.0),
    ([None, None], None),
])
def test_the_share_of_estimations_replayed(counts, share, monkeypatch):
    """Only the iterations' estimation spans count (the constructor's
    does not); estimations that all ran eagerly read 0; a plan with
    none, as CEM's, reads nothing."""
    assert READ(_run(_plan(counts), monkeypatch)) == share


def test_the_manifest_lists_the_reader_for_the_irs_cells():
    entry = {m["name"]: m for m in harness.manifest()["per_layer"]}[
        "estimation.graph_share"]
    assert entry["workloads"] == ["box_pushing.zero_order_B",
                                  "planar_hand.zero_order_B"]
    assert entry["source"] == READ.__globals__["SOURCE"] == "program_span"
