"""The yardstick's arithmetic against the bounds the port's kernel table
records (H100 SXM peaks, bytes once) and against hand counts."""

import pytest

from benchmark import roofline


def test_b3_bound_at_1m_x_64_bf16():
    ms, by = roofline.mips_topk_bound_s(1_000_000, 64, 8192, 500)
    assert by == "operations"
    assert ms * 1e3 == pytest.approx(1.060, abs=5e-4)


def test_b5_bound_at_8192_x_125000():
    s, by = roofline.select_bound_s(8192, 125_000, 93)
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(1.225, abs=5e-4)


def test_b1_bound_at_deepfm_layout():
    """bench.py's DeepFM layout: 26 x 32,768 ids, slots 64 + 1, bf16
    gradients, 725,870 distinct rows (uniform ids)."""
    s, by = roofline.b1_bound_s(26 * 32768, 725_870, (64, 1), 2)
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(0.152, abs=5e-4)


def test_segment_merge_bytes_by_hand():
    """1M items, one 1024-query chunk, k = 10,000: 8 segments of 125,000,
    seg_k = 1250 + 625 = 1875."""
    assert roofline.segmented_plan(1_000_000, 1024, 10_000) == \
        (1875, 125_000, 1)
    per_segment = 8192 * 125_000 * 4 + 8192 * 1875 * 8
    merge = 1024 * 15_000 * 8 + 1024 * 10_000 * 8
    assert roofline.segmented_select_bytes(1_000_000, 1024, 10_000) == \
        per_segment + merge


def test_deepfm_flops_by_hand():
    """configs/models/deepfm.yaml: 39 fields x 16 → 400 → 400 → 400 → 1;
    forward 2·(624·400 + 400·400 + 400·400 + 400·1), backward twice it."""
    forward = 2 * (624 * 400 + 400 * 400 + 400 * 400 + 400)
    assert forward == 1_140_000
    assert roofline.deepfm_flops_per_example(39, 16, (400, 400, 400)) == \
        3 * forward


def test_serve_flops_by_hand():
    """configs/models/youtubednn.yaml: the user tower 128 → 256 → 128 → 64
    and 2 · 1M · 64 for the scores."""
    tower = 2 * (128 * 256 + 256 * 128 + 128 * 64)
    assert roofline.serve_flops_per_user(1_000_000, 64, (256, 128, 64)) == \
        tower + 2 * 1_000_000 * 64
