"""Kernel K1 (CUDA Riccati backward pass) against the plain PyTorch loop.

The tests marked ``skipif`` need a CUDA device and skip on the CPU; run them
on a machine with an H100 and the CUDA toolkit with

    python -m pytest tests/test_torch_kernels.py -q

The wrapper's argument checks run everywhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from irs_mpc_torch import IrsMpc, IrsMpcParams, SmoothingConfig, \
    make_pendulum  # noqa: E402
from irs_mpc_torch.ops import cuda_riccati, lqr  # noqa: E402

# The condition is a string so that it is evaluated when the test runs,
# not when the module is imported.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def _cuda_problems():
    pend, pend_du = chip_smoke.pendulum_problems()
    return {"pendulum": pend, "bench": chip_smoke.bench_problem(),
            "delta_u": pend_du}


@needs_cuda
@pytest.mark.parametrize("case", ["pendulum", "bench", "delta_u"])
def test_kernel_matches_plain_loop(case):
    prob = lqr.LqrProblem(*(a.contiguous() for a in _cuda_problems()[case]))
    ref = lqr.riccati_backward_plain(prob)
    before = cuda_riccati.LAUNCHES
    K, k = cuda_riccati.riccati_backward_cuda(prob)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES == before + 1
    # The bound of the JAX package's kernel check: max error relative to
    # the largest gain, for K and for k.
    for got, want in ((K, ref.K), (k, ref.k)):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel < chip_smoke.REL_TOL


@needs_cuda
def test_dispatch_launches_kernel_on_cuda():
    prob = _cuda_problems()["pendulum"]
    before = cuda_riccati.LAUNCHES
    gains = lqr.riccati_backward(prob)
    assert cuda_riccati.LAUNCHES == before + 1
    assert gains.P is None and gains.K.is_cuda


@needs_cuda
def test_slice_on_cuda_launches_once_per_iteration():
    T = 50
    params = IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode="zero_order",
        smoothing=SmoothingConfig(num_samples=200, std_x=1.0, std_u=1.0))
    s = IrsMpc(make_pendulum(0.05), params, device="cuda")
    before = cuda_riccati.LAUNCHES
    s.iterate(3, verbose=False)
    assert cuda_riccati.LAUNCHES == before + 3
    assert s.cost_best < s.cost_lst[0]


def _cpu_problem(T=4, n=3, m=2):
    rng = np.random.RandomState(0)

    def f(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    return lqr.LqrProblem(A=f(T, n, n), B=f(T, n, m), c=f(T, n),
                          Q=f(T, n, n), R=f(T, m, m), N=f(T, n, m),
                          q=f(T, n), r=f(T, m), Qf=f(n, n), qf=f(n),
                          x0=f(n))


@pytest.mark.parametrize("fault, match", [
    (lambda p: p, "CUDA tensors"),
    (lambda p: p._replace(Q=p.Q.double()), "float32"),
    (lambda p: p._replace(c=p.c[:, :2]), "shape"),
    (lambda p: p._replace(A=p.A.transpose(1, 2)), "contiguous"),
    (lambda p: p._replace(B=torch.zeros(4, 3, 17), R=torch.zeros(4, 17, 17),
                          N=torch.zeros(4, 3, 17), r=torch.zeros(4, 17)),
     "m <= 16"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault, match):
    before = cuda_riccati.LAUNCHES
    with pytest.raises(ValueError, match=match):
        cuda_riccati.riccati_backward_cuda(fault(_cpu_problem()))
    assert cuda_riccati.LAUNCHES == before
