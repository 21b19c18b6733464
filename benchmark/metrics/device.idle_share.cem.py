"""``device.idle_share`` in the CEM cells, where it moves ``plan_ms.cem``."""
from benchmark.harness import metric_reader

_BASE = metric_reader("device.idle_share")
SOURCE, read = _BASE.SOURCE, _BASE.read
