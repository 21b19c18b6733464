"""The share of the marked plans' estimation sweeps that ran as one CUDA
graph replay: the program's ``estimation`` spans inside iterations that
count ``est_graph``, over all of them.  Not read where the marked plans
hold no such span (CEM)."""
from benchmark.program_trace import marked

SOURCE = "program_span"


def read(run):
    m = marked(run)
    if m is None:
        return None
    spans = [s for s in m.spans
             if s.name == "estimation" and s.top == "iteration"]
    if not spans:
        return None
    return sum(1 for s in spans if s.counts.get("est_graph")) / len(spans)
