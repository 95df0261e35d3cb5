"""The count arithmetic of the roofline shares, against sums by hand."""

from portbench.counts import ingest_scan, msm_windows, peaks


def test_ingest_scan_bytes():
    # 3 sessions, 10 votes reach the scan, 7 applied:
    # 3 x (26 + 12) + 10 + 2 x 7
    assert ingest_scan.bytes_needed(3, 10, 7) == 3 * 38 + 10 + 14
    assert ingest_scan.bytes_needed(0, 0, 0) == 0


def test_field_and_point_costs():
    assert msm_windows.CARRY == 132
    assert msm_windows.FE_MUL == 896 + 16 + 132
    assert msm_windows.FE_SQR == 476 + 32 + 16 + 132
    assert msm_windows.FE_ADD == msm_windows.FE_SUB == 148
    assert msm_windows.POINT_ADD == 9 * 1044 + 9 * 148
    assert msm_windows.POINT_DBL == 4 * 656 + 4 * 1044 + 8 * 148


def test_msm_windows_ops():
    per_point = 78 * msm_windows.POINT_ADD + 252 * msm_windows.POINT_DBL
    assert msm_windows.PER_POINT == per_point
    assert msm_windows.ops_needed(16_000) == 32_001 * per_point
    assert msm_windows.ops_needed(0) == 0


def test_peaks():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.INT_OPS_PER_S == 33.5e12
