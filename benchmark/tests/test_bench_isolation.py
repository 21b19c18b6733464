"""What the benchmark loads: the whole import graph of ``run.py`` for
every cell holds no module of ``jax``, ``jaxlib``, ``flax`` or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference pulls in nothing of the port."""
import json
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "irs_mpc_tpu"}

GRAPH = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.check, benchmark.program
from benchmark import harness
for w in harness.manifest()["workloads"]:
    c = harness.cell(w["name"])
    benchmark.check.reference_model(c.config, benchmark.check.Arith())
    for m in c.per_layer:
        harness.metric_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.planner, benchmark.reference.box_pushing
import benchmark.reference.planar_hand, benchmark.check, benchmark.counts
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_runs_import_graph_holds_no_jax():
    names = top_level(GRAPH)
    assert "irs_mpc_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    names = top_level(REFERENCE)
    assert "benchmark" in names
    assert not names & (FORBIDDEN | {"irs_mpc_torch", "chip_smoke"})
