"""Device kernels (not copies or fills) in the marked plans, constructors
included, over their iterations: a count that repeats exactly."""
from benchmark.tracing import is_kernel

SOURCE = "device_trace"


def read(run):
    b = run.marked
    if b is None or not b.device or not b.iterations:
        return None
    return sum(is_kernel(d.name) for d in b.device) / b.iterations
