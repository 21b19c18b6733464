"""Host ms an iteration spends costing trajectories (the lanes' costs of
iRS; the population's and the refit mean's of CEM)."""
from benchmark.readers import ms_per_iteration

SOURCE = "program_span"


def read(run):
    return ms_per_iteration(run, "cost")
