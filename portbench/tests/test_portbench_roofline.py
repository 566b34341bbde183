"""The operation and byte counts of the rooflines, at the shapes the cells
run."""

import pytest
import torch

from portbench.metrics import _roofline as R

NORTH = (5, 512, 512, 512, 512)          # w, M, K1, K2, N at chi=256


def test_sandwich_flops_at_the_north_star():
    assert R.sandwich_flops(*NORTH) == 2_684_354_560
    assert R.sandwich_flops(*NORTH, complex_=True) == 4 * 2_684_354_560


def test_sandwich_bounds_at_the_north_star():
    w, M, K1, K2, N = NORTH
    a, b = (w, M, K1), (w, K2, N)
    assert R.sandwich_bound_s(a, b, torch.float64) == pytest.approx(
        4.0065e-5, rel=1e-4)              # 0.0401 ms: operations bound it
    assert R.sandwich_bound_s(a, b, torch.complex128) == pytest.approx(
        4 * 4.0065e-5, rel=1e-4)          # 0.160 ms
    assert R.sandwich_bound_s(a, b, torch.float32) == pytest.approx(
        5.4229e-6, rel=1e-4)              # 0.0054 ms at 495 TFLOP/s
    nbytes = R.sandwich_bytes(*NORTH, 8)
    assert nbytes / R.PEAK_BYTES_PER_S < R.sandwich_bound_s(
        a, b, torch.float64)


def test_a_thin_sandwich_is_bound_by_its_bytes():
    a, b = (5, 2, 2), (5, 512, 512)
    flops = R.sandwich_flops(5, 2, 2, 512, 512) / R.PEAK_FLOPS[torch.float64]
    nbytes = R.sandwich_bytes(5, 2, 2, 512, 512, 8) / R.PEAK_BYTES_PER_S
    assert nbytes > flops
    assert R.sandwich_bound_s(a, b, torch.float64) == nbytes


def test_sector_matvec_bound_of_the_4x6_torus():
    D = 2_704_156
    assert R.sector_matvec_bytes(D) == 24 * D
    assert R.sector_matvec_bound_s(D) == pytest.approx(1.9373e-5, rel=1e-4)
