"""The roofline arithmetic against the bounds PERF.md's kernel table gives
(chip_smoke.py's 3xTF32 bound: three TF32 products at 495 TFLOP/s a
fp32 one, bytes at 3.35 TB/s)."""
import numpy as np
import pytest

from ubis_bench import roofline


def test_phase1_bound_at_q256():
    # PERF.md §6, row 2: phase 1, 256 x 65,504 x 128 -> 0.0261 ms (3xTF32)
    ms = roofline.scores(256, 65504, 128).seconds() * 1e3
    assert round(ms, 4) == 0.0261


def test_cache_scan_bound_at_q256():
    # PERF.md §6, row 2: the cache scan, 256 x 4,096 x 128 -> 0.0016 ms
    ms = roofline.scores(256, 4096, 128).seconds() * 1e3
    assert round(ms, 4) == 0.0016


def test_peaks():
    assert roofline.PEAK_PRODUCT == pytest.approx(165e12)
    assert roofline.PEAK_FP32 == 67e12
    assert roofline.PEAK_BYTES == 3.35e12


def test_float_scan_is_bytes_bound():
    w = roofline.float_scan(10000, 32, 96, 128, tiles=20000)
    assert w.bytes == 20000 * 96 * (4 * 128 + 5)
    assert w.seconds() == pytest.approx(w.bytes / roofline.PEAK_BYTES)


def test_batch_counts_distinct_tiles_once():
    index = dict(dim=128, max_postings=65504, capacity=96,
                 cache_capacity=4096)
    probe = np.array([[3, 5, -1], [5, 3, 7]])
    ids = np.array([[1, 2], [2, -1]])
    got = roofline.search_batch(index, 2, probe, ids)
    want = (roofline.scores(2, 65504, 128) + roofline.scores(2, 4096, 128)
            + roofline.float_scan(2, 3, 96, 128, tiles=3))
    assert got == want


def test_quant_batch_counts_returned_rows():
    index = dict(dim=128, max_postings=64, capacity=96, cache_capacity=32,
                 use_pq=True, pq_m=16, pq_ksub=256, pq_versions=2,
                 rerank_k=192)
    probe = np.array([[1, 2], [2, 9]])
    ids = np.array([[4, 5], [5, -1]])
    got = roofline.search_batch(index, 2, probe, ids)
    want = (roofline.scores(2, 64, 128) + roofline.scores(2, 32, 128)
            + roofline.pq_scan(2, 2, 96, 128, 16, 256, 2, tiles=3, R=192,
                               rows=2))
    assert got == want
