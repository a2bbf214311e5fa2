import math

import pytest

from benchmark import peaks


def test_known_and_unknown_cards():
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    assert peaks.peaks_for("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    with pytest.raises(ValueError, match="no published peaks"):
        peaks.peaks_for("cpu")


def test_upola_call_work_at_the_render_cell():
    # P=15, 20 blocks of 32768, C=64, K=32769, f32 planes
    nbytes, flops = peaks.upola_call_work(15, 20, 64, 1, 32768, "split")
    row = 2 * 64 * 32769 * 4
    assert nbytes == (14 * row + 15 * row + 2 * 15 * 32769 * 4
                      + 2 * 64 * 20 * 32768 * 4 + 2 * 64 * 32768 * 4)
    assert 840e6 < nbytes < 845e6  # the delay line read and rewritten dominates
    assert flops == 20 * 64 * (2 * 2.5 * 65536 * 16 + 8 * 15 * 32769)
    least, bound = peaks.roofline_seconds(nbytes, flops,
                                          peaks.peaks_for("NVIDIA H100 80GB HBM3"))
    assert bound == "memory"
    assert math.isclose(least, nbytes / 3.35e12)


def test_short_calls_rewrite_only_their_rows():
    one, f1 = peaks.upola_call_work(15, 1, 64, 1, 32768, "split")
    many, f20 = peaks.upola_call_work(15, 20, 64, 1, 32768, "split")
    row = 2 * 64 * 32769 * 4
    assert many - one == 14 * row + 19 * 2 * 64 * 32768 * 4
    assert math.isclose(f20, 20 * f1)


def test_storage_itemsize_scales_the_delay_line():
    b32, _ = peaks.upola_call_work(15, 20, 64, 1, 32768, "split")
    b8, _ = peaks.upola_call_work(15, 20, 64, 1, 32768, "int8")
    assert b32 - b8 == 29 * 2 * 64 * 32769 * (4 - 1)  # only the delay line shrinks


def test_compute_bound_when_flops_dominate():
    least, bound = peaks.roofline_seconds(1.0, 67e12, peaks.PEAKS["NVIDIA H100 80GB HBM3"])
    assert bound == "compute" and math.isclose(least, 1.0)
