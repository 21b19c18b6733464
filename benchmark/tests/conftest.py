"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository.  On the CPU they hold the frozen counters and
the reference to the port's originals and drive the harness end to end on
the port's plain path; the tests marked ``card`` need the H100 and skip
elsewhere (run them there with the same command)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never when the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def _program_unpatched():
    """Undo what a run patches (the recorder on the solvers' steps, the
    spans on the layer calls), so each test drives the program as it
    ships."""
    from benchmark import program
    owners = [(program.IrsMpc, "_iteration"),
              (program.IrsMpc, "_build_problem"),
              (program.CrossEntropyMethod, "_step")]
    owners += [(owner, attr) for owner, attr, _ in program.LAYER_CALLS]
    saved = [(o, a, getattr(o, a)) for o, a in owners]
    yield
    for o, a, v in saved:
        setattr(o, a, v)
