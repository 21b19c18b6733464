"""The yardstick's arithmetic: the card's published peaks, and the operations
and bytes each layer's work needs, counted from the problem's shapes.

``riccati_flops``, ``plan_flops``, ``pdip_flops``, ``admm_flops`` and
``chain_flops`` are frozen copies of the counters in ``chip_smoke.py``
(``benchmark/tests/test_bench_counts.py`` holds them to the originals).
They count what the algorithm needs, never what a kernel happens to do, so
a layer's roofline reads the same work whatever implements it.  Nothing
here imports the program.
"""
from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the full 700 W): float32 outside the tensor cores, and HBM3 bandwidth.
F32_PEAK = 67e12          # operations per second
HBM_RATE = 3.35e12        # bytes per second
F32_BYTES = 4


def riccati_flops(T, n, m):
    """Operations of a Riccati backward pass with a cross term, per knot:
    A'PA, B'PB and B'PA (4n³ + 4n²m + 2nm²), the Gauss-Jordan solve of
    Quu against [Qux | qu] (2m²(m + n + 1)), the value update (2n²m) and
    the vector terms (4n² + 4nm)."""
    return T * (4 * n ** 3 + 6 * n ** 2 * m + 2 * n * m ** 2
                + 2 * m ** 2 * (m + n + 1) + 4 * n ** 2 + 4 * n * m)


def plan_flops(T, n, m):
    """Operations of the linear plan: per knot u = -(Kx + k) (2mn) and
    x = Ax + Bu + c (2n² + 2nm)."""
    return T * (2 * n * n + 4 * n * m)


def pdip_flops(B, n, m, iters):
    """Operations of ``iters`` PDIP iterations on B QPs of n unknowns and m
    rows: H = P + C'WC (2mn²), its Gauss-Jordan solve (2n²(n + 1)), the four
    products with C or C' (8mn) and the row-wise updates (~20m)."""
    return B * iters * (2 * m * n * n + 2 * n * n * (n + 1) + 8 * m * n
                        + 20 * m)


def admm_flops(T, n, m, iters):
    """Operations of K3: the Riccati factorisation with H⁻¹ (4m³ per
    knot), then per sweep and knot the affine backward pass, the rollout and
    the consensus updates (6n² + 10nm + 2m² + 10(n + m))."""
    return (riccati_flops(T, n, m) + T * 4 * m ** 3
            + iters * T * (6 * n * n + 10 * n * m + 2 * m * m
                           + 10 * (n + m)))


def chain_flops(A, T, nq, m, nz, rows, iters):
    """Operations of K4: per lane and knot the feedback law (2m·nz), the
    narrow phase and row assembly (~30 per row and unknown) and ``iters``
    PDIP iterations with a diagonal P (3·rows·nq² for H, 2nq²(nq + 1) for
    its solve, 8·rows·nq for the products, ~20 per row)."""
    return A * T * (iters * (3 * rows * nq * nq + 2 * nq * nq * (nq + 1)
                             + 8 * rows * nq + 20 * rows)
                    + 2 * m * nz + 30 * rows * nq)


# ---------------------------------------------------------------------------
# Each layer's work for one call, from the shapes the harness recorded
# ---------------------------------------------------------------------------

def qp_bytes(B, n, m):
    """float32 bytes of B QPs' operands read once (P, q, C, d) and their
    solutions written once."""
    return F32_BYTES * B * (n * n + n + m * n + m + n)


def estimation_work(T, S, nq, rows, qp_iters, sample_iters):
    """(operations, bytes) of one zero-order estimation sweep: the T
    nominal steps at ``qp_iters`` PDIP iterations and the T·S sample steps
    at ``sample_iters``."""
    flops = (pdip_flops(T, nq, rows, qp_iters)
             + pdip_flops(T * S, nq, rows, sample_iters))
    return flops, qp_bytes(T, nq, rows) + qp_bytes(T * S, nq, rows)


def lqr_work(T, n, m, sweeps, box_kinds):
    """(operations, bytes) of one boxed trajectory QP of state size n (the
    augmented state in Δu mode) and m inputs: the unconstrained solve with
    its plan (K1), then ``sweeps`` ADMM sweeps (K3).  Bytes: the problem
    (A, B, c, Q, R, N, q, r, Qf, qf, x0), one (lb, ub) pair of (T, m) per
    box kind, and the plan and gains written (x, u, K, k)."""
    flops = (admm_flops(T, n, m, sweeps) + riccati_flops(T, n, m)
             + plan_flops(T, n, m))
    problem = (T * (2 * n * n + 2 * n * m + m * m + 2 * n + m)
               + n * n + 2 * n)
    bounds = box_kinds * 2 * T * m
    out = (T + 1) * n + T * m + T * m * n + T * m
    return flops, F32_BYTES * (problem + bounds + out)


def chain_work(A, T, nq, m, nz, rows, iters, aug, rel):
    """(operations, bytes) of one line-searched (or open-loop) rollout
    chain of A lanes: inputs x0, u_prev0, K, the lanes' state and input
    references, the input bounds (and the relative ones), and the lanes'
    states and inputs written."""
    flops = chain_flops(A, T, nq, m, nz, rows, iters)
    ins = (nq + m + T * m * nz + A * T * nq + (A * T * m if aug else 0)
           + A * T * m + 2 * T * m + (2 * T * m if rel else 0))
    out = A * (T + 1) * nq + A * T * m
    return flops, F32_BYTES * (ins + out)


def roofline_share(flops, nbytes, device_s):
    """(percent of the roofline, which bound sets it) for work that took
    ``device_s`` seconds of device time: the larger of the operations over
    the float32 peak and the bytes over the memory rate, over the time."""
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    bound = "operations" if t_ops >= t_bytes else "bytes"
    return 100.0 * max(t_ops, t_bytes) / device_s, bound
