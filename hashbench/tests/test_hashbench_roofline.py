"""The roofline counts of B1, B2, B7 and B8 from shapes, and the peaks."""
import pytest
import torch

from hashbench.roofline import b1, b2, b7, b8, least_seconds, peaks


def test_b1_counts_ten_ops_an_evaluation_and_each_byte_once():
    ops, nbytes = b1.cost(nnz_total=1000, rows=10, k=500, bits=16)
    assert ops == 10 * 1000 * 500
    assert nbytes == 4 * 1000 + 4 * 10 + 10 * 1000


def test_b1_packs_straddling_codes_into_whole_bytes():
    assert b1.cost(8, 1, k=3, bits=3)[1] == 4 * 8 + 4 + 2


@pytest.mark.parametrize("mask,extra", [(False, 0), (True, 10 * 32)])
def test_b2_counts_the_mask_only_where_the_scheme_returns_it(mask, extra):
    ops, nbytes = b2.cost(nnz_total=1000, rows=10, k=256, bits=8, mask=mask)
    assert ops == 11 * 1000
    assert nbytes == 4 * 1000 + 4 * 10 + 10 * 256 + extra


def test_b7_reads_each_gathered_table_row_once():
    ops, nbytes = b7.cost(rows=100, k=500, n_out=1, distinct=7000)
    assert ops == 100 * 500
    assert nbytes == 4 * 100 * 500 + 4 * 7000 + 4 * 100


def test_b8_writes_the_dense_table_once():
    ops, nbytes = b8.cost(rows=100, k=500, vsize=65536, n_out=1)
    assert ops == 100 * 500
    assert nbytes == 4 * 100 * 500 + 4 * 100 + 4 * 500 * 65536


def test_least_seconds_takes_the_longer_bound():
    assert least_seconds((10.0, 1.0), 5.0, 1.0) == 2.0
    assert least_seconds((1.0, 10.0), 5.0, 1.0) == 10.0
    assert least_seconds((1e9, 10.0), None, 1.0) == 10.0


def test_peaks_are_none_off_the_card():
    assert peaks.for_device(torch.device("cpu")) is None


def test_int32_peak_is_sms_times_dispatch_lanes_times_clock(monkeypatch):
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    monkeypatch.setattr(peaks, "max_sm_clock_hz", lambda i: 1.98e9)
    p = peaks.for_device(torch.device("cuda", 0))
    assert p["int32_ops_per_s"] == 132 * 128 * 1.98e9
    assert p["hbm_bytes_per_s"] == 3.35e12
