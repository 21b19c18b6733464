"""Device-idle ms an iteration spends inside the program's ``estimation``
spans (the estimation sweep and decouple_AB): each span's time less the
device's busy time in it, per iteration of the marked plans."""
from benchmark.program_trace import idle_ms_per_iteration

SOURCE = "program_span"


def read(run):
    return idle_ms_per_iteration(run, "estimation")
