"""The counts of operations and bytes at a small shape, by hand."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import counts


def test_estep_and_kernel_bounds_by_hand():
    src_len, trg_len = np.array([3, 5]), np.array([1, 2])  # S_n = 2, 4
    assert counts.state_steps(src_len, trg_len) == (3 * 2 + 5 * 4, 3 * 4 + 5 * 16)
    assert counts.estep_ops(src_len, trg_len) == 7 * 92
    # K7: 26 entries, ids [2, 5], states [2, 4], a 10 x 3 table
    b = 4 * (26 + 10 + 8 + 30)
    assert counts.k7_bound_ms(src_len, trg_len, 2, 5, 2, 10, 3) == pytest.approx(
        max(b / 3.35e12, 26 / 67e12) * 1e3)
    assert counts.k3_bound_ms(src_len, trg_len, 2, 5, 2) == pytest.approx(
        4 * (26 + 24 + 16 + 20) / 3.35e12 * 1e3)
    assert counts.k4_bound_ms(src_len, trg_len, 2, 2) == pytest.approx(
        4 * (52 + 24 + 2 + 32) / 3.35e12 * 1e3)
    assert counts.k2_bound_ms(src_len, trg_len, 2, 5, 2, 10, 3) == pytest.approx(
        4 * (26 + 10 + 4 + 32 + 30) / 3.35e12 * 1e3)


def test_bound_takes_the_larger_side():
    assert counts.bound_ms(3.35e9, 0.0) == pytest.approx(1.0)
    assert counts.bound_ms(0.0, 67e9) == pytest.approx(1.0)
    assert counts.gauss_product_ops(10, 4, 6) == 4 * 2 * 10 * 4 * 6
