"""The roofline functions against counts made by hand."""
import pytest

from vobench import roofline


def test_level_gn_bound_by_hand():
    # C=1, K=16384, one iteration: read points 12K + valid K + pixels 4K
    # + Jacobians 24K + taps 16K + 80 B of pose and normalization;
    # written 264 B + weights 4K
    nbytes, ops = roofline.level_gn(1, 16384, 1)
    assert nbytes == 16384 * 57 + 80 + 264 + 16384 * 4 == 999768
    assert ops == 16384 * (20 + 71) + 16384 * 32 == 2015232
    t, by = roofline.bound_s(nbytes, ops)
    assert by == "bytes" and t == pytest.approx(999768 / 3.35e12)


def test_level_gn_c8_iterations_count_operations():
    nbytes, ops = roofline.level_gn(8, 16384, 20)
    assert nbytes == 16384 * (13 + 8 * 48) + 344
    assert ops == 20 * 16384 * (20 + 71 * 8) + 16384 * 32
    assert roofline.bound_s(nbytes, ops)[1] == "operations"


def test_sgm_bound_by_hand():
    nbytes, ops = roofline.sgm_call(376, 1241, 128)
    assert nbytes == 2 * 376 * 1241 * 128 * 4 == 477814784
    assert ops == 32 * 376 * 1241 * 128
    t, by = roofline.bound_s(nbytes, ops)
    assert by == "bytes" and t == pytest.approx(142.63e-6, rel=1e-4)
