"""The frozen counters of ``benchmark/counts.py`` against the originals in
``chip_smoke.py``, at three shapes each."""
import pytest

import chip_smoke
from benchmark import counts

SHAPES = [(60, 7, 2, 30), (30, 11, 4, 12), (200, 2, 1, 60)]


@pytest.mark.parametrize("T, n, m, iters", SHAPES)
def test_lqr_counters_match_the_originals(T, n, m, iters):
    assert counts.riccati_flops(T, n, m) == chip_smoke.riccati_flops(T, n, m)
    assert counts.plan_flops(T, n, m) == chip_smoke.plan_flops(T, n, m)
    assert (counts.admm_flops(T, n, m, iters)
            == chip_smoke.admm_flops(T, n, m, iters))


@pytest.mark.parametrize("B, n, m, iters",
                         [(6000, 5, 2, 15), (1500, 7, 10, 15), (60, 5, 2, 30)])
def test_pdip_counter_matches_the_original(B, n, m, iters):
    assert (counts.pdip_flops(B, n, m, iters)
            == chip_smoke.pdip_flops(B, n, m, iters))


@pytest.mark.parametrize("A, T, nq, m, nz, rows, iters",
                         [(6, 60, 5, 2, 7, 2, 10), (2000, 30, 7, 4, 7, 10, 10),
                          (6, 20, 11, 2, 13, 18, 10)])
def test_chain_counter_matches_the_original(A, T, nq, m, nz, rows, iters):
    assert (counts.chain_flops(A, T, nq, m, nz, rows, iters)
            == chip_smoke.chain_flops(A, T, nq, m, nz, rows, iters))


def test_peaks_match_the_originals():
    assert (counts.F32_PEAK, counts.HBM_RATE) == (chip_smoke.F32_PEAK,
                                                  chip_smoke.HBM_RATE)


@pytest.mark.parametrize("B, n, m", [(6000, 5, 2), (1500, 7, 10), (3, 2, 1)])
def test_qp_bytes_count_each_operand_once(B, n, m):
    import torch
    ops = [torch.zeros(B, n, n), torch.zeros(B, n), torch.zeros(B, m, n),
           torch.zeros(B, m), torch.zeros(B, n)]
    assert counts.qp_bytes(B, n, m) == chip_smoke.tensor_bytes(ops)


def test_roofline_names_its_bound():
    share, bound = counts.roofline_share(67e12, 1.0, 2.0)
    assert bound == "operations" and share == pytest.approx(50.0)
    share, bound = counts.roofline_share(1.0, 3.35e12, 4.0)
    assert bound == "bytes" and share == pytest.approx(25.0)
