"""Kernels a knot of the plain warm chain launches: the kernels launched
inside the program's ``chain`` spans (``System.rollout``, the initial
guess's rollout in an iRS constructor) over those spans' ``knots``, in
the marked plans."""
from benchmark.program_trace import kernels_per_count

SOURCE = "program_span"


def read(run):
    return kernels_per_count(run, "chain", "knots")
