"""Port parity: the goldens of ``tests/test_golden_contact.py`` for box
pushing and box pivoting, with the port's own random stream, on the CPU
(the plain versions of K1-K4): initial cost at rtol 1e-3 and best within
12% after 8 descents, without a kernel launch.  The CPU runs the same warm
scan chain as the JAX goldens; the configurations are ``chip_smoke``'s,
which ``tests/test_torch_box.py`` holds to the JAX package's examples.
Carrots' initial cost, a deterministic rollout of its 45-dof pile, and
plate pickup's (the plain warm chain: ``chain_gate`` keeps K4 off its
prismatic fingers) are held to their goldens the same way; their descents
run on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from irs_mpc_torch.models.contact import cuda_qp, cuda_rollout  # noqa: E402
from irs_mpc_torch.models.contact import rollout as trollout  # noqa: E402
from irs_mpc_torch.ops import cuda_admm, cuda_riccati  # noqa: E402

KERNELS = (cuda_riccati, cuda_qp, cuda_admm, cuda_rollout)


def _launches():
    return [mod.LAUNCHES for mod in KERNELS]


@pytest.mark.parametrize("name, initial, best", [
    ("box_pushing", chip_smoke.BOX_PUSHING_INITIAL,
     chip_smoke.BOX_PUSHING_BEST),
    ("box_pivoting", chip_smoke.BOX_PIVOTING_INITIAL,
     chip_smoke.BOX_PIVOTING_BEST)])
def test_box_golden_on_cpu(name, initial, best):
    solver, model = getattr(chip_smoke, f"{name}_solver")("cpu")
    assert trollout.supports_model(model) and trollout.chain_gate(model)
    before = _launches()
    solver.iterate(chip_smoke.BOX_ITERATIONS, verbose=False)
    assert _launches() == before
    np.testing.assert_allclose(solver.cost_lst[0], initial, rtol=1e-3)
    assert abs(solver.cost_best - best) <= chip_smoke.BOX_BEST_RTOL * best
    assert all(t.device.type == "cpu" for t in (solver.x_trj, solver.u_trj))


def test_carrots_initial_cost_on_cpu():
    solver, model = chip_smoke.carrots_solver("cpu")
    assert not trollout.supports_model(model)    # nq = 45: no K4
    assert solver.system.ls_rollout_fn is None
    np.testing.assert_allclose(solver.cost_lst[0], chip_smoke.CARROTS_INITIAL,
                               rtol=1e-3)


def test_plate_pickup_initial_cost_on_cpu():
    solver, model = chip_smoke.plate_pickup_solver("cpu")
    assert trollout.supports_model(model)
    assert not trollout.chain_gate(model)        # prismatic fingers
    assert solver.system.ls_rollout_fn is None
    np.testing.assert_allclose(solver.cost_lst[0], chip_smoke.PLATE_INITIAL,
                               rtol=1e-3)
