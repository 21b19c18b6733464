"""Device-idle ms an iteration spends inside CEM's ``sample`` spans (the
AR(1) noise loop, the kept elites and the box clip), per iteration of the
marked plans."""
from benchmark.program_trace import idle_ms_per_iteration

SOURCE = "program_span"


def read(run):
    return idle_ms_per_iteration(run, "sample")
