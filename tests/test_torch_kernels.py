"""The hand-written CUDA kernels against their plain PyTorch versions:
K1 (Riccati backward pass), K2 (batched PDIP), K3 (whole-loop boxed ADMM)
and K4 (whole-chain contact line search).

The tests marked ``skipif`` need a CUDA device and skip on the CPU; run them
on a machine with an H100 and the CUDA toolkit with

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The wrappers' argument checks run everywhere: each wrapper raises on CPU
tensors, another dtype or shape, and sizes past its kernel's limits,
before anything is launched.  All four CUDA sources also run on the CPU,
through the g++ emulation of ``irs_mpc_torch.tools.cpu_shim``."""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import irs_mpc_torch  # noqa: E402
from irs_mpc_torch import IrsMpc, IrsMpcParams, SmoothingConfig, \
    make_pendulum, make_planar_hand  # noqa: E402
from irs_mpc_torch.models.contact import cuda_qp, cuda_rollout  # noqa: E402
from irs_mpc_torch.ops import admm, cuda_admm, cuda_riccati, lqr  # noqa: E402
from irs_mpc_torch.utils import timing  # noqa: E402

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
@pytest.mark.parametrize("case, where", [
    ("pendulum", "shared"), ("bench", "streamed"), ("delta_u", "shared"),
    ("wide_shared", "shared"), ("wide_streamed", "streamed")])
def test_lqr_solve_kernel_matches_plain_on_card(case, where):
    """K1 with the plan in the same launch, in both placements of the
    knots' operands, at widths 2, 4, 16, 32 (n = 20, staged) and 64 (n =
    50, streamed): K, k, x and u within REL_TOL of
    the largest plain value, x and u against ``lqr_rollout_linear`` on the
    plain gains."""
    if case.startswith("wide"):
        T = 4 if case == "wide_shared" else 12
        prob, _ = chip_smoke.delta_u_problem(
            T=T, n=15 if case == "wide_shared" else 45, m=5, seed=3,
            spread=0.03)
    else:
        prob = _cuda_problems()[case]
    prob = lqr.LqrProblem(*(a.contiguous() for a in prob))
    assert cuda_riccati.placement(*prob.B.shape) == where
    ref = lqr.riccati_backward_plain(prob)
    xr, ur = lqr.lqr_rollout_linear(prob, ref)
    before = cuda_riccati.LAUNCHES
    x, u, K, k = cuda_riccati.lqr_solve_cuda(prob)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES == before + 1
    for got, want in ((K, ref.K), (k, ref.k), (x, xr), (u, ur)):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel < chip_smoke.REL_TOL


@needs_cuda
def test_dispatch_launches_kernel_on_cuda():
    """``riccati_backward`` and ``lqr_solve`` on CUDA tensors: one launch
    each, P and p kept on chip."""
    prob = _cuda_problems()["pendulum"]
    before = cuda_riccati.LAUNCHES
    gains = lqr.riccati_backward(prob)
    assert cuda_riccati.LAUNCHES == before + 1
    assert gains.P is None and gains.K.is_cuda
    x, u, solved = lqr.lqr_solve(prob)
    assert cuda_riccati.LAUNCHES == before + 2
    assert solved.P is None and x.is_cuda and x.shape == (prob.B.shape[0]
                                                          + 1, 2)


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


# ---------------------------------------------------------------------------
# K2, K3, K4
# ---------------------------------------------------------------------------

@needs_cuda
def test_qp_kernel_matches_plain_on_card():
    """Cold at the slice's two iteration counts, with duals, and warm from
    them: solutions and duals against the plain PDIP's at the smoke run's
    tolerances, and the JAX package's bulk-agreement criterion."""
    qps = chip_smoke.planar_hand_qps(B=300)
    before = cuda_qp.LAUNCHES
    for iters in (15, 30):
        (x, lam), (xr, lamr), rel = chip_smoke.qp_gaps(qps, iters)
        assert max(rel) <= chip_smoke.QP_REL_TOL
    (xw, _), (xwr, _), rel = chip_smoke.qp_gaps(qps, 6, init=(x, lam),
                                                init_plain=(xr, lamr))
    assert max(rel) <= chip_smoke.QP_WARM_REL_TOL
    assert cuda_qp.LAUNCHES == before + 3
    scale = xr.abs().max().item()
    for got, want in ((x, xr), (xw, xwr)):
        rel = (got - want).abs().amax(1) / scale
        assert torch.quantile(rel, 0.5).item() < 2e-2


@needs_cuda
@pytest.mark.parametrize("kinds", [("x",), ("dx",), ("x", "u"), ("du",),
                                   ("u", "du")])
def test_admm_kernel_matches_plain_on_card(kinds):
    prob, n_phys = chip_smoke.delta_u_problem()
    T, n, m = prob.B.shape
    idx_w = torch.arange(n_phys, n, device="cuda")
    bounds = chip_smoke.delta_u_bounds(kinds, T, n_phys, m)
    z0, y0 = chip_smoke.admm_initial(prob, bounds, n_phys, idx_w)
    before = cuda_admm.LAUNCHES
    err = chip_smoke.admm_errors(prob, bounds, z0, y0, n_phys=n_phys,
                                 idx_w=idx_w, rho=5.0, iters=12,
                                 over_relax=1.6)
    assert cuda_admm.LAUNCHES == before + 1 and err < chip_smoke.ADMM_TOL
    # The dispatch: one K1 launch for the initial solve, one K3 launch.
    launches = (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES)
    sol = admm.solve_boxed_tvlqr(prob, bounds, n_phys=n_phys, idx_w=idx_w,
                                 rho=5.0, iters=12, over_relax=1.6)
    assert (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES) == (
        launches[0] + 1, launches[1] + 1)
    assert sol.gains.P is None and sol.u_trj.is_cuda


@needs_cuda
def test_rollout_kernel_matches_plain_and_slice_launches_on_card():
    """K4 on the line search of the slice's first iteration, then the
    slice's launches: 1 each of K1, K3 and K4 per iteration, and K2's 2
    an iteration inside the estimation sweep's CUDA graph, which the host
    launches in its capture's warm-up and not in a replay."""
    _, _, (args, _) = chip_smoke.first_iteration_inputs()
    before = cuda_rollout.LAUNCHES
    xs, us = cuda_rollout.linesearch_rollout_cuda(*args)
    xr, ur = chip_smoke.rollout.linesearch_rollout_plain(*args)
    torch.cuda.synchronize()
    assert cuda_rollout.LAUNCHES == before + 1
    assert (xs - xr).abs().max().item() < chip_smoke.CHAIN_ATOL
    assert (us - ur).abs().max().item() < chip_smoke.CHAIN_ATOL

    solver, _ = chip_smoke.planar_hand_solver("cuda")
    mods = (cuda_qp, cuda_riccati, cuda_admm, cuda_rollout)
    before = [mod.LAUNCHES for mod in mods]
    timing.reset()
    with timing.tracing():
        solver.iterate(2, verbose=False)
    sweeps = [r.counts for r in timing.records() if r.name == "estimation"]
    timing.reset()
    assert sweeps == [{"est_graph": 1, "est_capture": 1}, {"est_graph": 1}]
    assert [mod.LAUNCHES - b for mod, b in zip(mods, before)] == [2, 2, 2, 2]
    assert solver.cost_best < solver.cost_lst[0]


@needs_cuda
@pytest.mark.parametrize("n, m", [(5, 8), (16, 64), (1, 1)])
def test_qp_kernel_generic_shapes_match_plain_on_card(n, m):
    """Shapes other than the models' take the kernel's generic
    instance: random strictly convex QPs with feasible boxes.  A few hard
    lanes of such a batch are float32-sensitive at 30 iterations: at
    (16, 64) the plain float32 solve is off the float64 one by 2.0e-4 at
    p90 and 4.4e-2 at p99 of max|x|, the kernel by 2.8e-4 and 2.3e-2, and
    the two float32 solves differ by 1.2e-3 at p90.  So the tail is held
    against the float64 solve at the same iteration count: at p90 and p99
    the kernel, x and duals, is no less accurate than the plain float32
    version (within 2.5x), and the bulk and p90 agree with it."""
    g = torch.Generator().manual_seed(n * 100 + m)
    B = 257                                   # a ragged last block

    def f(*shape):
        return torch.randn(*shape, generator=g)

    L = f(B, n, n) * 0.3
    P = torch.eye(n) + L @ L.transpose(1, 2)
    args = [a.cuda() for a in (P, f(B, n), f(B, m, n), f(B, m).abs() + 0.1)]
    before = cuda_qp.LAUNCHES
    x, lam = cuda_qp.solve_qp_batched(*args, 30, want_lam=True)
    xr, lamr = cuda_qp.solve_qp_batched_plain(*args, 30, want_lam=True)
    x64, lam64 = (a.float() for a in cuda_qp.solve_qp_batched_plain(
        *[a.double() for a in args], 30, want_lam=True))
    conv = cuda_qp.solve_qp_batched_plain(*[a.double() for a in args],
                                          200).float()
    torch.cuda.synchronize()
    assert cuda_qp.LAUNCHES == before + 1
    assert bool(torch.isfinite(x).all() and torch.isfinite(lam).all())
    assert lam.min().item() >= 0.0

    def p(a, b, pct, ref):
        scale = ref.abs().max().item() + 1e-9
        return torch.quantile((a - b).abs().amax(1) / scale, pct).item()

    assert p(x, conv, 0.9, conv) < max(2.5 * p(xr, conv, 0.9, conv), 5e-2)
    for got, plain, ref in ((x, xr, x64), (lam, lamr, lam64)):
        for pct in (0.9, 0.99):
            assert p(got, ref, pct, ref) <= max(
                2.5 * p(plain, ref, pct, ref), 1e-6)
    assert p(x, xr, 0.5, conv) < 1e-4
    assert p(x, xr, 0.9, conv) < 5e-3


@needs_cuda
@pytest.mark.parametrize("n, m", [(7, 10), (5, 2), (5, 18), (8, 16), (3, 4)])
def test_qp_kernel_instances_match_plain_on_card(n, m):
    """Every compile-time instance (planar hand, box pushing, box pivoting,
    plate pickup) and the generic one, on the CPU shim test's random QPs:
    257 QPs (a ragged last block), cold at 8 iterations with the duals,
    then warm from them at 4, at the smoke run's QP_REL_TOL and
    QP_WARM_REL_TOL (short solves, before float32 leaves the active rows
    undetermined)."""
    qps = [a.cuda() for a in _random_qps(257, n, m, seed=10 * n + m)]
    before = cuda_qp.LAUNCHES
    x, lam = cuda_qp.solve_qp_batched(*qps, 8, want_lam=True)
    xw, lamw = cuda_qp.solve_qp_batched(*qps, 4, init=(x, lam),
                                        want_lam=True)
    xr, lamr = cuda_qp.solve_qp_batched_plain(*qps, 8, want_lam=True)
    xwr, lamwr = cuda_qp.solve_qp_batched_plain(*qps, 4, init=(xr, lamr),
                                                want_lam=True)
    torch.cuda.synchronize()
    assert cuda_qp.LAUNCHES == before + 2
    for got, want, tol in ((x, xr, chip_smoke.QP_REL_TOL),
                           (lam, lamr, chip_smoke.QP_REL_TOL),
                           (xw, xwr, chip_smoke.QP_WARM_REL_TOL),
                           (lamw, lamwr, chip_smoke.QP_WARM_REL_TOL)):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= tol


@needs_cuda
def test_admm_kernel_on_a_plain_tracking_problem_on_card():
    """No Δu augmentation (n_phys = n): u and x boxes on the random
    n=16, m=4 problem of ``chip_smoke.bench_problem``, cut to T=30."""
    prob = chip_smoke.bench_problem(T=30)
    T, n, m = prob.B.shape
    bounds = admm.BoxBounds(
        x=torch.stack([torch.full((T + 1, n), -1.0, device="cuda"),
                       torch.full((T + 1, n), 1.0, device="cuda")]),
        u=torch.stack([torch.full((T, m), -0.3, device="cuda"),
                       torch.full((T, m), 0.3, device="cuda")]))
    z0, y0 = chip_smoke.admm_initial(prob, bounds, n, None)
    err = chip_smoke.admm_errors(prob, bounds, z0, y0, n_phys=n, idx_w=None,
                                 rho=1.0, iters=12, over_relax=1.6)
    assert err < chip_smoke.ADMM_TOL


@needs_cuda
@pytest.mark.parametrize("n_phys, m, T, where", [
    (34, 16, 5, "shared"),        # n = 50
    (48, 16, 5, "shared"),        # n = 64
    (34, 16, 10, "streamed"),     # n = 50, ~245 KB of operands
    (48, 16, 12, "streamed"),     # n = 64
])
def test_admm_kernel_wide_matches_plain_on_card(n_phys, m, T, where):
    """K3 at the widths past the planar hand (carrots' n = 50 and the
    limit n = 64, m = 16), in both placements of the knots' operands: in
    shared memory, and streamed from the global scratch through the
    chains' cp.async ring.  Near-identity dynamics (spread 0.03), where
    float32 determines the solution (``chip_smoke.delta_u_problem``)."""
    prob, _ = chip_smoke.delta_u_problem(T=T, n=n_phys, m=m, seed=3,
                                         spread=0.03)
    n = prob.B.shape[1]
    assert cuda_admm.placement(T, n, m) == where
    idx_w = torch.arange(n_phys, n, device="cuda")
    for kinds in (("u", "du"), ("x", "dx")):
        bounds = chip_smoke.delta_u_bounds(kinds, T, n_phys, m)
        z0, y0 = chip_smoke.admm_initial(prob, bounds, n_phys, idx_w)
        err = chip_smoke.admm_errors(prob, bounds, z0, y0, n_phys=n_phys,
                                     idx_w=idx_w, rho=1.0, iters=8,
                                     over_relax=1.6)
        assert err < chip_smoke.ADMM_TOL


@needs_cuda
def test_admm_kernel_streams_the_long_horizon_on_card():
    """T = 200, n = 16, m = 4 (the shape of K1's bench row): ~450 KB of
    knots' operands, past shared memory, so the chains stream them."""
    prob = chip_smoke.bench_problem()
    T, n, m = prob.B.shape
    assert cuda_admm.placement(T, n, m) == "streamed"
    bounds = admm.BoxBounds(
        x=torch.stack([torch.full((T + 1, n), -1.0, device="cuda"),
                       torch.full((T + 1, n), 1.0, device="cuda")]),
        u=torch.stack([torch.full((T, m), -0.3, device="cuda"),
                       torch.full((T, m), 0.3, device="cuda")]))
    z0, y0 = chip_smoke.admm_initial(prob, bounds, n, None)
    err = chip_smoke.admm_errors(prob, bounds, z0, y0, n_phys=n, idx_w=None,
                                 rho=1.0, iters=12, over_relax=1.6)
    assert err < chip_smoke.ADMM_TOL


def _chain_inputs(aug, rel):
    """Line-search inputs around the planar hand's resting state
    (``chip_smoke.chain_inputs``: input boxes with an inf and a NaN
    entry)."""
    model = make_planar_hand()
    return model, chip_smoke.chain_inputs(
        model, chip_smoke.CONTACT_Q0["planar_hand"], aug=aug, rel=rel)


@needs_cuda
@pytest.mark.parametrize("aug, rel, canon", [(True, True, False),
                                             (False, False, False),
                                             (False, True, True)])
def test_rollout_kernel_variants_match_plain_on_card(aug, rel, canon):
    model, args = _chain_inputs(aug, rel)
    model = dataclasses.replace(model, canon_warm_duals=canon)
    before = cuda_rollout.LAUNCHES
    xs, us = cuda_rollout.linesearch_rollout_cuda(model, **args)
    xr, ur = chip_smoke.rollout.linesearch_rollout_plain(model, **args)
    torch.cuda.synchronize()
    assert cuda_rollout.LAUNCHES == before + 1
    assert bool(torch.isfinite(xs).all())
    assert (xs - xr).abs().max().item() < chip_smoke.CHAIN_ATOL
    assert (us - ur).abs().max().item() < chip_smoke.CHAIN_ATOL
    if rel:
        du = us[:, 1:] - us[:, :-1]
        assert du.abs().max().item() <= 0.02 + 1e-5


@needs_cuda
@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize("name", ["planar_hand", "box_pushing",
                                  "box_pivoting", "plate_pickup",
                                  "circle_pair"])
def test_rollout_kernel_on_every_pair_kind_on_card(name, swapped):
    """All eleven pair kinds, each in both orders: capsule-circle and
    halfspace-circle (planar hand), box-circle (box pushing), halfspace-box
    with canonicalised duals (box pivoting), capsule-box on prismatic
    fingers (plate pickup), circle-circle (``chip_smoke``'s model)."""
    model = chip_smoke.contact_models()[name]
    if swapped:
        model = chip_smoke.swap_pairs(model)
    for aug, rel in ((True, True), (False, False)):
        args = chip_smoke.chain_inputs(model, chip_smoke.CONTACT_Q0[name],
                                       aug=aug, rel=rel)
        before = cuda_rollout.LAUNCHES
        xs, us = cuda_rollout.linesearch_rollout_cuda(model, **args)
        xr, ur = chip_smoke.rollout.linesearch_rollout_plain(model, **args)
        torch.cuda.synchronize()
        assert cuda_rollout.LAUNCHES == before + 1
        assert bool(torch.isfinite(xs).all())
        assert (xs - xr).abs().max().item() < chip_smoke.CHAIN_ATOL
        assert (us - ur).abs().max().item() < chip_smoke.CHAIN_ATOL


@needs_cuda
@pytest.mark.parametrize("name", ["box_pushing", "box_pivoting"])
def test_box_slice_launches_on_card(name):
    """Per iteration of a box slice: 1 launch each of K1, K3 and K4, and
    K2's 2 inside the estimation sweep's CUDA graph, as the planar
    hand."""
    solver, _ = getattr(chip_smoke, f"{name}_solver")("cuda")
    mods = (cuda_qp, cuda_riccati, cuda_admm, cuda_rollout)
    before = [mod.LAUNCHES for mod in mods]
    timing.reset()
    with timing.tracing():
        solver.iterate(2, verbose=False)
    sweeps = [r.counts for r in timing.records() if r.name == "estimation"]
    timing.reset()
    assert sweeps == [{"est_graph": 1, "est_capture": 1}, {"est_graph": 1}]
    assert [mod.LAUNCHES - b for mod, b in zip(mods, before)] == [2, 2, 2, 2]
    assert solver.cost_best < solver.cost_lst[0]


@needs_cuda
def test_carrots_slice_launches_on_card():
    """Carrots (45 dof, 500 rows) is past K2's and K4's limits: per
    iteration one launch each of K1 and K3 (n = 45 + 5, m = 5) and none of
    K2 and K4, its contact solves plain PyTorch on the card."""
    solver, _ = chip_smoke.carrots_solver("cuda")
    np.testing.assert_allclose(solver.cost_lst[0],
                               chip_smoke.CARROTS_INITIAL, rtol=1e-3)
    mods = (cuda_qp, cuda_riccati, cuda_admm, cuda_rollout)
    before = [mod.LAUNCHES for mod in mods]
    solver.iterate(2, verbose=False)
    assert [mod.LAUNCHES - b for mod, b in zip(mods, before)] == [0, 2, 2, 0]
    assert solver.cost_best < solver.cost_lst[0]


# ---------------------------------------------------------------------------
# The CUDA sources on the CPU, through tools.cpu_shim (g++, one OS thread per
# CUDA thread): the kernels' arithmetic, barriers and shuffles, against the
# plain versions, at small shapes.
# ---------------------------------------------------------------------------

SHIM_SOURCES = ("admm", "rollout", "riccati", "pdip")


@pytest.fixture(scope="module")
def shim_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the CPU emulation of the kernels")
    from irs_mpc_torch.ops import _nvcc
    from irs_mpc_torch.tools import cpu_shim
    libs = cpu_shim.build_all([_nvcc.CSRC / f"{name}.cu"
                               for name in SHIM_SOURCES],
                              tmp_path_factory.mktemp("shim"))
    return dict(zip(SHIM_SOURCES, libs))


def _cpu(f):
    """Run ``chip_smoke``'s constructor ``f`` for CPU tensors."""
    saved, chip_smoke.DEVICE = chip_smoke.DEVICE, "cpu"
    try:
        return f()
    finally:
        chip_smoke.DEVICE = saved


@pytest.mark.parametrize("n_phys, m, T, kinds, cap", [
    (4, 3, 6, ("x", "u"), None),             # n = 7: width 8, shared
    (4, 3, 6, ("dx", "du"), 4096),           # the same, streamed
    (11, 5, 3, ("u", "du"), None),           # n = 16
    (28, 5, 3, ("x", "du"), 8192),           # n = 33: two rows a lane
])
def test_admm_source_on_cpu_shim(shim_libs, n_phys, m, T, kinds, cap):
    """K3's source against the plain loop at chain widths 8, 16 and 64, in
    both placements of the knots' operands (a small shared-memory cap
    forces the streamed one), at the card tests' tolerances."""
    from irs_mpc_torch.tools import cpu_shim
    lib = shim_libs["admm"]
    cpu_shim.set_smem_cap(lib, cap or 232448)
    cuda_admm._placements.clear()
    prob, _ = _cpu(lambda: chip_smoke.delta_u_problem(
        T=T, n=n_phys, m=m, seed=3, spread=0.1))
    n = prob.B.shape[1]
    idx_w = torch.arange(n_phys, n)
    bounds = _cpu(lambda: chip_smoke.delta_u_bounds(kinds, T, n_phys, m))
    z0, y0 = chip_smoke.admm_initial(prob, bounds, n_phys, idx_w)
    kw = dict(n_phys=n_phys, idx_w=idx_w, rho=1.0, iters=3, over_relax=1.6)
    try:
        with cpu_shim.attached(cuda_admm, lib):
            assert cuda_admm.placement(T, n, m) == (
                "streamed" if cap else "shared")
            x, u, K, k, z, zp = cuda_admm.solve_boxed_tvlqr_cuda(
                prob, bounds, z0, y0, **kw)
    finally:
        cpu_shim.set_smem_cap(lib, 232448)
        cuda_admm._placements.clear()
    xr, ur, gr, zr, zpr = admm._admm_plain(prob, bounds, z0, y0, n_phys,
                                           idx_w, 1.0, 3, 1.6)
    for got, want in ((x, xr), (u, ur), (K, gr.K), (k, gr.k)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=chip_smoke.ADMM_TOL,
                                   atol=chip_smoke.ADMM_TOL)
    for kd in kinds:
        np.testing.assert_allclose(getattr(z, kd).numpy(),
                                   getattr(zr, kd).numpy(),
                                   atol=chip_smoke.ADMM_TOL)


@pytest.mark.parametrize("name, swapped, aug, rel, canon", [
    ("planar_hand", False, True, True, False),
    ("box_pushing", True, False, False, False),
    ("box_pivoting", False, True, False, True),
    ("plate_pickup", True, True, True, False),
    ("circle_pair", False, False, True, True),
])
def test_rollout_source_on_cpu_shim(shim_libs, name, swapped, aug, rel,
                                    canon):
    """K4's source against the plain chain over the pair kinds, both
    orders, with and without the prev-input block, relative bounds and
    canonicalised duals, at CHAIN_ATOL."""
    from irs_mpc_torch.tools import cpu_shim
    model = chip_smoke.contact_models()[name]
    if swapped:
        model = chip_smoke.swap_pairs(model)
    model = dataclasses.replace(model, canon_warm_duals=canon)
    args = chip_smoke.chain_inputs(model, chip_smoke.CONTACT_Q0[name], A=2,
                                   T=4, aug=aug, rel=rel, device="cpu")
    with cpu_shim.attached(cuda_rollout, shim_libs["rollout"]):
        xs, us = cuda_rollout.linesearch_rollout_cuda(model, **args)
    xr, ur = chip_smoke.rollout.linesearch_rollout_plain(model, **args)
    assert bool(torch.isfinite(xs).all())
    assert (xs - xr).abs().max().item() < chip_smoke.CHAIN_ATOL
    assert (us - ur).abs().max().item() < chip_smoke.CHAIN_ATOL


@pytest.mark.parametrize("T, n_phys, m, cap, where", [
    (5, 1, 1, None, "shared"),        # n = 2: width 2, one warp
    (3, 3, 1, 1300, "streamed"),      # n = 4: width 4
    (4, 5, 2, None, "shared"),        # n = 7: width 8, 64 threads
    (4, 5, 2, 4000, "streamed"),
    (3, 9, 4, None, "shared"),        # n = 13: width 16, m padded to 4
    (3, 9, 4, 12000, "streamed"),
    (2, 14, 4, None, "shared"),       # n = 18: width 32, 256 threads
    (3, 13, 5, 48000, "streamed"),    # m padded to 8
    (2, 45, 5, None, "shared"),       # n = 50 (carrots): width 64
    (3, 45, 5, 150000, "streamed"),
])
def test_riccati_source_on_cpu_shim(shim_libs, T, n_phys, m, cap, where):
    """K1's source against the plain loop and the plain plan at every
    compile-time width, in both placements of the knots' operands (a small
    shared-memory cap forces the streamed one):
    K, k, x and u within REL_TOL of the largest plain value, and the
    backward pass alone with the same gains."""
    from irs_mpc_torch.tools import cpu_shim
    lib = shim_libs["riccati"]
    cpu_shim.set_smem_cap(lib, cap or 232448)
    cuda_riccati._placements.clear()
    prob, _ = _cpu(lambda: chip_smoke.delta_u_problem(
        T=T, n=n_phys, m=m, seed=n_phys, spread=0.1))
    prob = lqr.LqrProblem(*(a.contiguous() for a in prob))
    try:
        with cpu_shim.attached(cuda_riccati, lib):
            assert cuda_riccati.placement(*prob.B.shape) == where
            x, u, K, k = cuda_riccati.lqr_solve_cuda(prob)
            K0, k0 = cuda_riccati.riccati_backward_cuda(prob)
    finally:
        cpu_shim.set_smem_cap(lib, 232448)
        cuda_riccati._placements.clear()
    ref = lqr.riccati_backward_plain(prob)
    xr, ur = lqr.lqr_rollout_linear(prob, ref)
    for got, want in ((K, ref.K), (k, ref.k), (x, xr), (u, ur)):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel < chip_smoke.REL_TOL
    assert torch.equal(K0, K) and torch.equal(k0, k)


def _random_qps(B, n, m, seed):
    """B random strictly convex QPs with feasible boxes (the construction
    of the card test of the generic instance)."""
    g = torch.Generator().manual_seed(seed)
    L = torch.randn(B, n, n, generator=g) * 0.3
    return (torch.eye(n) + L @ L.transpose(1, 2), torch.randn(B, n,
                                                              generator=g),
            torch.randn(B, m, n, generator=g),
            torch.randn(B, m, generator=g).abs() + 0.1)


@pytest.mark.parametrize("n, m, B", [
    (7, 10, 5),      # planar hand: 16 lanes a QP
    (5, 2, 19),      # box pushing: 8 lanes, a ragged last block
    (5, 18, 3),      # box pivoting: 32 lanes
    (8, 16, 3),      # plate pickup: 16 lanes
    (3, 4, 3),       # the generic instance, 16 columns
    (16, 40, 2),     # the generic instance, two rows a lane
])
def test_pdip_source_on_cpu_shim(shim_libs, n, m, B):
    """K2's source against the plain PDIP on each compile-time instance and
    the generic one: cold at 8 iterations with the duals, then warm from
    them at 4, at the smoke run's QP_REL_TOL and QP_WARM_REL_TOL."""
    from irs_mpc_torch.tools import cpu_shim
    qps = _random_qps(B, n, m, seed=10 * n + m)
    with cpu_shim.attached(cuda_qp, shim_libs["pdip"]):
        x, lam = cuda_qp.solve_qp_batched_cuda(*qps, 8, want_lam=True)
        xw, lamw = cuda_qp.solve_qp_batched_cuda(*qps, 4, init=(x, lam),
                                                 want_lam=True)
    xr, lamr = cuda_qp.solve_qp_batched_plain(*qps, 8, want_lam=True)
    xwr, lamwr = cuda_qp.solve_qp_batched_plain(*qps, 4, init=(xr, lamr),
                                                want_lam=True)
    for got, want, tol in ((x, xr, chip_smoke.QP_REL_TOL),
                           (lam, lamr, chip_smoke.QP_REL_TOL),
                           (xw, xwr, chip_smoke.QP_WARM_REL_TOL),
                           (lamw, lamwr, chip_smoke.QP_WARM_REL_TOL)):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= tol


def _cpu_qps(B=4, n=7, m=10):
    rng = np.random.RandomState(0)

    def f(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    return {"P": torch.eye(n).expand(B, n, n).contiguous(), "q": f(B, n),
            "C": f(B, m, n), "d": f(B, m).abs()}


def _zeros(*shape):
    return torch.zeros(shape)


@pytest.mark.parametrize("fault, match", [
    (lambda a: a, "CUDA tensors"),
    (lambda a: dict(a, P=a["P"].double()), "float32"),
    (lambda a: dict(a, C=a["C"][:, :, :5]), "shape"),
    (lambda a: dict(a, init=(_zeros(4, 7), _zeros(4, 9))), "shape"),
    (lambda a: dict(a, P=_zeros(4, 17, 17), q=_zeros(4, 17),
                    C=_zeros(4, 10, 17)), "n <= 16"),
    (lambda a: dict(a, C=_zeros(4, 65, 7), d=_zeros(4, 65)), "m <= 64"),
])
def test_qp_wrapper_refuses_what_the_kernel_does_not_take(fault, match):
    before = cuda_qp.LAUNCHES
    with pytest.raises(ValueError, match=match):
        cuda_qp.solve_qp_batched_cuda(**fault(_cpu_qps()))
    assert cuda_qp.LAUNCHES == before


def _cpu_admm(T=4, n=3, m=2, kinds=("u", "du")):
    """A Δu problem (n + m augmented states), its boxes and initial z, y."""
    rng = np.random.RandomState(1)

    def f(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    prob = lqr.build_delta_u_problem(
        torch.eye(n) + 0.1 * f(T, n, n), f(T, n, m), f(T, n),
        torch.eye(n), torch.eye(n), torch.eye(m), f(n),
        torch.zeros(T + 1, n), torch.arange(m))
    bounds = admm.BoxBounds(**{k: torch.stack([-torch.ones(T, m),
                                               torch.ones(T, m)])
                               for k in kinds})
    z = admm._SVals(**{k: torch.zeros(T, m) for k in kinds})
    return dict(prob=prob, bounds=bounds, z0=z, y0=z, n_phys=n,
                idx_w=torch.arange(n, n + m), rho=1.0, iters=3,
                over_relax=1.6)


@pytest.mark.parametrize("fault, match", [
    (lambda a: a, "CUDA tensors"),
    (lambda a: dict(a, prob=a["prob"]._replace(Q=a["prob"].Q.double())),
     "float32"),
    (lambda a: dict(a, bounds=a["bounds"]._replace(
        u=a["bounds"].u[:, :2])), "shape"),
    (lambda a: dict(a, idx_w=None), "du box"),
    (lambda a: dict(a, idx_w=torch.arange(2)), "du box"),
    (lambda a: dict(a, **_cpu_admm(n=63)), "n <= 64"),       # n = 65
])
def test_admm_wrapper_refuses_what_the_kernel_does_not_take(fault, match):
    before = cuda_admm.LAUNCHES
    with pytest.raises(ValueError, match=match):
        cuda_admm.solve_boxed_tvlqr_cuda(**fault(_cpu_admm()))
    assert cuda_admm.LAUNCHES == before


def _cpu_chain(A=2, T=3):
    model = make_planar_hand()
    nq, m = model.nq, model.dim_u
    x0 = torch.zeros(nq)
    return dict(model=model, x0=x0, u_prev0=torch.zeros(m),
                K=torch.zeros(T, m, nq + m), z_ref_x=torch.zeros(A, T, nq),
                z_ref_w=torch.zeros(A, T, m), u_ref=torch.zeros(A, T, m),
                lb=torch.full((T, m), -1.0), ub=torch.full((T, m), 1.0),
                rel_lb=None, rel_ub=None)


@pytest.mark.parametrize("fault, match", [
    (lambda a: a, "CUDA tensors"),
    (lambda a: dict(a, K=a["K"].double()), "float32"),
    (lambda a: dict(a, z_ref_x=a["z_ref_x"][:, :2]), "shape"),
    (lambda a: dict(a, z_ref_w=None), "columns"),
    (lambda a: dict(a, rel_lb=a["lb"]), "both rel bounds"),
    (lambda a: dict(a, model=dataclasses.replace(a["model"],
                                                 contact_model="lcp")),
     "does not take model"),
    # 35 pairs: 70 contact rows, past the kernel's 64.
    (lambda a: dict(a, model=dataclasses.replace(
        a["model"], pairs=a["model"].pairs * 7)), "does not take model"),
    # 12 pairs, but 36 contacts (a box on a halfspace touches at four
    # corners): 72 rows.
    (lambda a: dict(a, model=dataclasses.replace(
        irs_mpc_torch.make_box_pivoting(),
        pairs=irs_mpc_torch.make_box_pivoting().pairs * 4)),
     "does not take model"),
    # A kind the narrow phase does not have: an arm link on the ground.
    (lambda a: dict(a, model=dataclasses.replace(
        a["model"], pairs=a["model"].pairs + (dataclasses.replace(
            a["model"].pairs[-1], body_b=1),))), "does not take model"),
])
def test_rollout_wrapper_refuses_what_the_kernel_does_not_take(fault,
                                                               match):
    before = cuda_rollout.LAUNCHES
    with pytest.raises(ValueError, match=match):
        cuda_rollout.linesearch_rollout_cuda(**fault(_cpu_chain()))
    assert cuda_rollout.LAUNCHES == before


@needs_cuda
def test_resolve_on_card_launches_per_knot():
    """On the card every knot's boxed solve is one K1 launch (the ADMM's
    initial solve) and one K3 launch; the curve is the CPU's."""
    T = 12

    def solver(device):
        return IrsMpc(make_pendulum(0.05), chip_smoke.pendulum_resolve_params(
            "resolve", T=T), device=device)

    cpu, card = solver("cpu"), solver("cuda")
    cpu.iterate(2, verbose=False)
    cuda_riccati.LAUNCHES = cuda_admm.LAUNCHES = 0
    card.iterate(2, verbose=False)
    torch.cuda.synchronize()
    assert (cuda_riccati.LAUNCHES, cuda_admm.LAUNCHES) == (2 * T, 2 * T)
    np.testing.assert_allclose(card.cost_lst, cpu.cost_lst, rtol=1e-3)


@needs_cuda
def test_k4_on_cem_population_matches_plain_on_card():
    """K4 with K = 0 at the planar-hand CEM's 2000 lanes, against its
    plain chain (the rule of ``chip_smoke.k4_row``), and a contact CEM
    iteration's two launches."""
    calls = []
    cem, _ = chip_smoke.planar_hand_cem("cuda")
    with chip_smoke.capture(cuda_rollout, "linesearch_rollout_cuda", calls):
        cuda_rollout.LAUNCHES = 0
        cem.iterate(1, verbose=False)
        torch.cuda.synchronize()
    assert cuda_rollout.LAUNCHES == 2 and len(calls) == 2
    args = calls[0][0]
    assert args[6].shape[0] == 2000 and not args[3].any()
    chip_smoke.k4_row("planar_hand CEM population", args, "card",
                      plain_reps=1, float64_rule=True)


@needs_cuda
@pytest.mark.parametrize("name", ["box_pushing", "planar_hand"])
def test_constructor_chain_through_k4_matches_plain_on_card(name):
    """The iRS constructor's initial rollout at the examples' horizons
    (box pushing T=60, the planar hand T=30) is one K4 launch, within
    CHAIN_ATOL of the plain warm chain on the card, at its cost to
    rtol 1e-5."""
    build = getattr(chip_smoke, f"{name}_solver")
    before = cuda_rollout.LAUNCHES
    card, _ = build("cuda")
    torch.cuda.synchronize()
    assert cuda_rollout.LAUNCHES == before + 1
    plain_system = dataclasses.replace(card.system, ls_rollout_fn=None)
    plain = IrsMpc(plain_system, card.params, device="cuda")
    assert cuda_rollout.LAUNCHES == before + 1
    gap = (card.x_trj - plain.x_trj).abs().max().item()
    cost_gap = abs(card.cost - plain.cost) / abs(plain.cost)
    print(f"[K4 constructor] {name}: x gap {gap:.3e}, "
          f"relative cost gap {cost_gap:.3e}")
    assert card.x_trj.shape == plain.x_trj.shape
    assert gap < chip_smoke.CHAIN_ATOL
    assert cost_gap < 1e-5


@needs_cuda
def test_batched_step_route_matches_plain_on_card():
    """The surrogate's batched step on CUDA tensors is one K2 launch, and
    agrees with the plain PDIP on the same states."""
    model = irs_mpc_torch.make_plate_pickup()
    sur = model.estimation_surrogate()
    x = torch.tensor(chip_smoke.CONTACT_Q0["plate_pickup"],
                     dtype=torch.float32).expand(64, -1).contiguous()
    u = (x[:, torch.from_numpy(model.indices_u_into_x())]
         + 0.02 * torch.randn((64, model.dim_u),
                              generator=torch.Generator().manual_seed(0)))
    before = cuda_qp.LAUNCHES
    got = sur.step_batch(x.cuda(), u.cuda())
    torch.cuda.synchronize()
    assert cuda_qp.LAUNCHES == before + 1
    want = sur.step_batch(x, u)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
