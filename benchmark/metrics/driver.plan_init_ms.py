"""Host ms of a plan's constructor (the initial guess's rollout and cost),
synchronised at its ends, averaged over the window's unprofiled plans."""
SOURCE = "program_span"


def read(run):
    spans = [s for s in run.spans if s.layer == "plan_init" and s.block == "w"]
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) * 1e3 / len(spans)
