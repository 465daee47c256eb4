"""The operation and byte counts of the roofline and mfu metrics, and the
trace's busy time, against counts made by hand."""

import numpy as np
import pytest

from portbench import peaks, trace
from portbench import cell as cells

K1 = cells.load_module(cells.ROOT / "metrics" / "k1_roofline.py")
MFU = cells.load_module(cells.ROOT / "metrics" / "step_mfu_pct.py")
DENSE = {"approx": "none", "n": 4096, "precision": "float32"}
RFF = {"approx": "rff", "n": 65536, "m_total": 512, "precision": "float32"}


def test_bound_is_the_larger_of_operations_and_bytes():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_k1_bound_dense_and_rff():
    # 8 factorizations of 4096: 8 * 4096^3 / 3 = 1.8325e11 operations -> 2.735 ms;
    # their bytes, 8 * 2 * 4096^2 * 4 = 1.0737e9 -> 0.3205 ms
    assert K1.bound_s(DENSE, 8) == pytest.approx(8 * 4096**3 / 3 / 67e12)
    assert K1.bound_s(DENSE, 8) == pytest.approx(2.7351e-3, rel=1e-4)
    # 8 of 512: 3.579e8 operations -> 5.34 us; 16.78 MB -> 5.01 us
    assert K1.bound_s(RFF, 8) == pytest.approx(8 * 512**3 / 3 / 67e12)
    assert K1.bound_s({**RFF, "m_total": 64}, 8) == pytest.approx(8 * 2 * 64 * 64 * 4 / 3.35e12)


def test_step_flops():
    # dense: n^3 + 12 n^2 = 68719476736 + 201326592
    assert MFU.dense_flops(DENSE) == 68920803328.0
    # rff: 3 n m^2 + m^3 + 12 n m = 51539607552 + 134217728 + 402653184
    assert MFU.rff_flops(RFF) == 52076478464.0


def _summary(starts, durs, kernel=None):
    n = len(starts)
    return trace.Summary([f"k{i}" for i in range(n)], np.array(starts, np.int64),
                         np.array(durs, np.int64),
                         np.ones(n, bool) if kernel is None else np.array(kernel, bool),
                         ["aten::mm", "cudaLaunchKernel"], np.array([0, 5], np.int64),
                         np.array([100, 20], np.int64), np.array([False, True]))


def test_busy_time_is_the_union_of_intervals():
    # [0, 10) and [5, 20) overlap: 20 ns; [30, 35) and [34, 40): 10 ns
    s = _summary([0, 5, 30, 34], [10, 15, 5, 6])
    assert s.busy_s == pytest.approx(30e-9)
    assert s.kernels == 4


def test_gaps_are_named_by_the_host():
    s = _summary([0, 30, 60], [10, 5, 5])
    gaps = s.top_gaps(10)
    # 10..30 starts inside cudaLaunchKernel (5..20) under aten::mm (0..100);
    # 35..60 inside aten::mm alone
    assert gaps == [["aten__mm", pytest.approx(25e-9)],
                    ["aten__mm_cudaLaunchKernel", pytest.approx(20e-9)]]


def test_kernel_seconds_by_pattern_skips_copies():
    s = _summary([0, 10, 20], [10, 10, 10], kernel=[True, True, False])
    assert s.kernel_seconds(r"^k[02]$") == (pytest.approx(10e-9), 1)
