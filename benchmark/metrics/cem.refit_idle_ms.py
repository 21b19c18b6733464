"""Device-idle ms an iteration spends inside CEM's ``refit`` spans (top-k,
the elites' mean and std, momentum, then the divergence guard and the std
floor), per iteration of the marked plans."""
from benchmark.program_trace import idle_ms_per_iteration

SOURCE = "program_span"


def read(run):
    return idle_ms_per_iteration(run, "refit")
