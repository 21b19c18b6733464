"""The share of the marked plans' constructors that skipped the dynamics
probe, because their system had passed it on their device before: the
program's top-level ``plan_init`` spans that count ``probe_reused``, over
all of them.  0 on a program that probes in every constructor; not read
where the marked plans hold no such span."""
from benchmark.program_trace import marked

SOURCE = "program_span"


def read(run):
    m = marked(run)
    if m is None:
        return None
    spans = [s for s in m.spans if s.name == "plan_init" and s.top is None]
    if not spans:
        return None
    return sum(1 for s in spans if s.counts.get("probe_reused")) / len(spans)
