"""``device.kernels_per_iter`` in the CEM cells, where it moves ``plan_ms.cem``."""
from benchmark.harness import metric_reader

_BASE = metric_reader("device.kernels_per_iter")
SOURCE, read = _BASE.SOURCE, _BASE.read
