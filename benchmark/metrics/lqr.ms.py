"""Host ms an iteration spends in the boxed trajectory QP (K1, K3)."""
from benchmark.readers import ms_per_iteration

SOURCE = "program_span"


def read(run):
    return ms_per_iteration(run, "lqr")
