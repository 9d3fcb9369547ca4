"""The yardstick's arithmetic against hand-worked values."""

from __future__ import annotations

import pytest

from vkbench import roofline

# K1 at the R-50 stage shape: one image, 117 kernels, the 48x156 map, 256 wide
R50 = (1, 117, 48, 156, 256)


def test_k1_bytes_and_bound_at_the_r50_stage_shape():
    flops, nbytes = roofline.k1_work(*R50)
    # logits 117*7488 + features 7488*256 + sums 117*256, four bytes each
    assert nbytes == 4 * (117 * 7488 + 7488 * 256 + 117 * 256) == 11_291_904
    assert flops == 2 * 117 * 7488 * 256 == 448_561_152
    # bytes bound it: 11.29 MB / 3.35 TB/s = 3.37 us (0.45 us of operations)
    assert roofline.bound_seconds("k1", R50) == pytest.approx(3.3707e-6, rel=1e-4)


def test_k2_moves_the_same_bytes_the_other_way():
    flops, nbytes = roofline.k2_work(*R50)
    assert (flops, nbytes) == roofline.k1_work(*R50)


def test_a_compute_bound_shape_takes_the_operations():
    shape = (1, 1000, 64, 64, 4096)  # wide features: 2*N*C/(4*(N+C)) flops a byte
    flops, nbytes = roofline.k2_work(*shape)
    assert flops / roofline.BF16_FLOPS > nbytes / roofline.HBM_BYTES_PER_S
    assert roofline.bound_seconds("k2", shape) == flops / roofline.BF16_FLOPS


def test_roofline_share_cannot_pass_100_when_the_time_is_the_bound_or_more():
    counts = {R50: 3, (8, 117, 48, 156, 256): 2}
    least = sum(roofline.bound_seconds("k1", s) * n for s, n in counts.items())
    assert roofline.roofline_share("k1", counts, least) == pytest.approx(100.0)
    assert roofline.roofline_share("k1", counts, 4 * least) == pytest.approx(25.0)
    assert roofline.roofline_share("k1", {}, 1.0) is None
    assert roofline.roofline_share("k1", counts, 0.0) is None


def test_mfu_against_the_fp32_peak():
    # 1.5e11 operations a frame at 50 frames/s: 7.5e12/s of 67e12
    assert roofline.mfu(1.5e11 * 500, 10.0) == pytest.approx(100 * 7.5e12 / 67e12)
    assert roofline.mfu(0, 1.0) is None
