"""The inputs the kernels are held and timed at: what a path's first
iteration hands each kernel's wrapper, recorded from a run on the card,
and the seeded T=200, n=16, m=4 tracking problem of the JAX package's
Riccati benchmark.  ``chip_smoke.py`` and ``probe_chains`` use them."""
import contextlib

import numpy as np
import torch

from ..models.contact import cuda_qp, cuda_rollout
from ..ops import cuda_admm, lqr


@contextlib.contextmanager
def capture(module, name, calls):
    """Record the arguments of every call of ``module.name`` in ``calls``
    (the call goes through unchanged), except calls made while a CUDA
    graph is being captured: those launch nothing.  The estimation's
    graph runs its sweep eagerly once before its capture, so a fresh
    solver's first iteration records K2's two calls as before."""
    real = getattr(module, name)

    def recording(*args, **kwargs):
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, real)


def first_iteration_inputs(solver_fn, rollouts=1, device="cuda"):
    """The arguments the first iteration of a contact path (``solver_fn``,
    a builder taking ``device=`` and returning (solver, model)) hands K2
    (its two calls), K3 and K4 (None for a path whose line search does not
    run K4: ``rollouts=0``), recorded from a run on the card."""
    k2, k3, k4 = [], [], []
    solver, _ = solver_fn(device=device)
    with capture(cuda_qp, "solve_qp_batched_cuda", k2), \
            capture(cuda_admm, "solve_boxed_tvlqr_cuda", k3), \
            capture(cuda_rollout, "linesearch_rollout_cuda", k4):
        solver.iterate(1, verbose=False)
    torch.cuda.synchronize()
    if not (len(k2) == 2 and len(k3) == 1 and len(k4) == rollouts):
        raise RuntimeError(f"first iteration: {len(k2)} QP, {len(k3)} ADMM "
                           f"and {len(k4)} rollout calls")
    return k2, k3[0], k4[0] if rollouts else None


def bench_problem(T=200, device="cuda"):
    """The random T=200, n=16, m=4 tracking problem, made from numpy seed 1
    by the construction of the JAX package's Riccati benchmark."""
    n, m = 16, 4
    rng = np.random.RandomState(1)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    A = f(np.eye(n)[None] + 0.05 * rng.randn(T, n, n))
    B = f(0.3 * rng.randn(T, n, m))
    c = f(0.05 * rng.randn(T, n))
    x0 = f(rng.randn(n))
    return lqr.build_tracking_problem(
        A, B, c, f(np.eye(n)), f(10.0 * np.eye(n)), f(np.eye(m)), x0,
        f(np.zeros((T + 1, n))))
