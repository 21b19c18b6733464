"""Host ms an iteration spends in the smoothed linearisation: the
estimation sweep (K2 in the zero-order modes) and decouple_AB."""
from benchmark.readers import ms_per_iteration

SOURCE = "program_span"


def read(run):
    return ms_per_iteration(run, "estimation")
