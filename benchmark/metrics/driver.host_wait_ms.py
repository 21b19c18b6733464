"""Host ms an iteration waits for the card: the time inside the program's
``sync`` spans (reads to the host, blocking copies from it) within
iterations, per iteration of the marked plans."""
from benchmark.program_trace import host_ms_per_iteration

SOURCE = "program_span"


def read(run):
    return host_ms_per_iteration(run, "sync")
