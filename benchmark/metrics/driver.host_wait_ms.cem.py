"""``driver.host_wait_ms`` in the CEM cells, where it moves
``plan_ms.cem``."""
from benchmark.harness import metric_reader

_BASE = metric_reader("driver.host_wait_ms")
SOURCE, read = _BASE.SOURCE, _BASE.read
