"""Port parity of the two mask kernels' plain versions against the Pallas
kernels (interpret mode) and the JAX ops they stand for. The CUDA launches are
held against these plain versions in tests/test_torch_port_cuda.py.

Tolerances: the contractions sum ~HW (pool) or C (assemble) fp32 terms in
another order than XLA: 1e-5 relative to the output's scale. The binarize
is exact, so the tie case (a logit of exactly 0 is not pooled) is checked
with exact zeros.
"""

import math

import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, n, t

from video_knet_tpu.models.kernel_update_head import assemble_masks as jax_assemble_masks
from video_knet_tpu.ops.mask_pool import mask_pool as jax_mask_pool
from video_knet_tpu.ops.pallas.mask_ops import fused_assemble_sigmoid, fused_mask_pool
from video_knet_tpu_torch.models.kernel_update_head import assemble_masks
from video_knet_tpu_torch.ops.kernels import mask_ops as mo
from video_knet_tpu_torch.ops.mask_pool import mask_pool

# (B, N, H, W, C): small serving-like, ragged N / HW / C (multiples of no tile)
SHAPES = [(1, 24, 12, 20, 64), (2, 13, 7, 9, 40), (1, 100, 5, 11, 36)]


def _logits(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    return np.where(x >= 0, np.maximum(x, 1e-6), np.minimum(x, -1e-6)).astype(np.float32)


@pytest.mark.parametrize("b,nn,h,w,c", SHAPES)
def test_mask_pool_plain_matches_pallas_and_jax(b, nn, h, w, c):
    rng = np.random.RandomState(nn)
    logits = _logits(rng, (b, nn, h, w))
    feats = rng.randn(b, h, w, c).astype(np.float32)
    got = mo.mask_pool_plain(t(logits), t(feats))
    assert_rel_close(got, fused_mask_pool(logits, feats, hard_thr=0.5, interpret=True),
                     1e-5, "vs Pallas")
    assert_rel_close(got, jax_mask_pool(logits, feats, hard_thr=0.5, binary=True), 1e-5,
                     "vs jnp mask_pool")
    # the port's op and the wrapper on CPU tensors take the plain version
    assert_rel_close(mask_pool(t(logits), t(feats), hard_thr=0.5), got, 0.0, "mask_pool")


@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_mask_pool_thresholds_and_soft_mode(thr):
    rng = np.random.RandomState(3)
    logits = _logits(rng, (1, 9, 6, 8))
    feats = rng.randn(1, 6, 8, 32).astype(np.float32)
    assert_rel_close(mask_pool(t(logits), t(feats), hard_thr=thr),
                     jax_mask_pool(logits, feats, hard_thr=thr, binary=True), 1e-5, "binary")
    assert_rel_close(mask_pool(t(logits), t(feats), hard_thr=thr, binary=False),
                     jax_mask_pool(logits, feats, hard_thr=thr, binary=False), 1e-5, "soft")


def test_mask_pool_zero_logit_is_not_pooled():
    rng = np.random.RandomState(4)
    logits = _logits(rng, (1, 6, 5, 7))
    logits[:, :2] = 0.0  # sigmoid(0) = 0.5 is not > 0.5
    logits[:, 2, 1, 3] = 0.0
    feats = rng.randn(1, 5, 7, 16).astype(np.float32)
    got = n(mo.mask_pool_plain(t(logits), t(feats)))
    assert (got[:, :2] == 0).all()
    np.testing.assert_allclose(
        got, np.asarray(fused_mask_pool(logits, feats, hard_thr=0.5, interpret=True)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,nn,h,w,c", SHAPES)
def test_assemble_plain_matches_pallas_and_jax(b, nn, h, w, c):
    rng = np.random.RandomState(nn + 1)
    kern = (rng.randn(b, nn, c) / np.sqrt(c)).astype(np.float32)
    feats = rng.randn(b, h, w, c).astype(np.float32)
    probs = mo.assemble_plain(t(kern), t(feats), sigmoid=True)
    assert_rel_close(probs, fused_assemble_sigmoid(kern, feats, interpret=True), 1e-5,
                     "sigmoid on vs Pallas")
    logits = mo.assemble_plain(t(kern), t(feats))
    want = jax_assemble_masks(kern[:, :, None], feats, 1)
    assert_rel_close(logits, want, 1e-5, "sigmoid off vs assemble_masks")
    assert_rel_close(assemble_masks(t(kern[:, :, None]), t(feats), 1), want, 1e-5,
                     "port assemble_masks")


def test_cpu_wrappers_launch_nothing():
    mo.reset_launch_counts()
    rng = np.random.RandomState(5)
    logits = t(_logits(rng, (1, 4, 3, 5)))
    feats = t(rng.randn(1, 3, 5, 8).astype(np.float32))
    mo.fused_mask_pool(logits, feats)
    mo.fused_assemble(t(rng.randn(1, 4, 8).astype(np.float32)), feats)
    assert mo.LAUNCHES == {"mask_pool": 0, "assemble": 0}


@pytest.mark.parametrize("lo_exp,hi_exp", [(-30, 30), (-4, 4), (-1, 1)])
def test_bf16x3_split_is_exact(lo_exp, hi_exp):
    """K1's tensor-core premise: each fp32 feature is the exact sum of three
    bf16 planes, so 0/1 x bf16 products into fp32 lose nothing."""
    rng = np.random.RandomState(lo_exp + 100)
    mag = 10.0 ** rng.uniform(lo_exp, hi_exp, size=100_000)
    x = t((np.where(rng.rand(mag.size) < 0.5, -mag, mag)).astype(np.float32))
    hi, mid, lo = mo.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert bool((total == x.double()).all())
    # each plane is the bf16 rounding of what the planes before it left
    assert bool((lo.float() == x - hi.float() - mid.float()).all())


def _wide(rng, size, lo_exp, hi_exp):
    mag = 10.0 ** rng.uniform(lo_exp, hi_exp, size=size)
    return t((np.where(rng.rand(*np.shape(mag)) < 0.5, -mag, mag)).astype(np.float32))


@pytest.mark.parametrize("lo_exp,hi_exp", [(-30, 30), (-4, 4), (-1, 1)])
def test_tf32x2_split_planes_are_tf32(lo_exp, hi_exp):
    """K2's split: big and small have TF32's 10 mantissa bits (the low 13
    bits zero, so the tensor cores see them exactly), big is x rounded to
    nearest with ties away from zero, and big + small is x within 2^-22."""
    rng = np.random.RandomState(lo_exp + 200)
    x = _wide(rng, 100_000, lo_exp, hi_exp)
    big, small = mo.split_tf32x2(x)
    assert big.dtype == small.dtype == torch.float32
    for plane in (big, small):
        assert bool(((plane.view(torch.int32) & 0x1FFF) == 0).all())
    xd = x.double()
    assert bool(((xd - big.double()).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((xd - big.double() - small.double()).abs() <= 2.0 ** -22 * xd.abs()).all())
    # ties go away from zero: 1 + 2^-11 lies halfway between two TF32 values
    tie = t(np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=np.float32))
    assert mo.split_tf32x2(tie)[0].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("lo_exp,hi_exp", [(-15, 15), (-4, 4), (-1, 1)])
def test_tf32x2_three_products_reproduce_fp64(lo_exp, hi_exp):
    """big_a*big_b + big_a*small_b + small_a*big_b, the three products K2
    runs on the tensor cores, is a*b within 2^-20 of |a*b|."""
    rng = np.random.RandomState(lo_exp + 300)
    a, b = _wide(rng, 100_000, lo_exp, hi_exp), _wide(rng, 100_000, lo_exp, hi_exp)
    (ba, sa), (bb, sb) = mo.split_tf32x2(a), mo.split_tf32x2(b)
    ba, sa, bb, sb = ba.double(), sa.double(), bb.double(), sb.double()
    want = a.double() * b.double()
    got = ba * bb + ba * sb + sa * bb
    assert bool(((got - want).abs() <= 2.0 ** -20 * want.abs()).all())


def test_tf32x2_product_meets_kernel_tolerance():
    """At the serving stage's N and C over a ragged HW ([117, 256] x [256,
    2257]), the 3xTF32 product summed in fp32 is within 1e-5 of the output's
    scale against fp64; a single TF32 pass is not."""
    rng = np.random.RandomState(17)
    kern = t((rng.randn(117, 256) / 16).astype(np.float32))
    feats = t(rng.randn(2257, 256).astype(np.float32))
    want = kern.double() @ feats.double().T
    (bk, sk), (bf, sf) = mo.split_tf32x2(kern), mo.split_tf32x2(feats)
    three = bk @ bf.T + bk @ sf.T + sk @ bf.T
    one = bk @ bf.T
    scale = float(want.abs().max())
    assert float((three.double() - want).abs().max()) <= 1e-5 * scale
    assert float((one.double() - want).abs().max()) > 1e-5 * scale


class _Tiles:
    """The tile sizes K1's library reports (csrc/mask_ops.cu)."""

    vk_mask_pool_block_rows = staticmethod(lambda: 128)
    vk_mask_pool_block_cols = staticmethod(lambda: 64)
    vk_mask_pool_block_hw = staticmethod(lambda: 32)


@pytest.mark.parametrize("b,nn,hw,c", [(1, 117, 7488, 256), (2, 117, 7488, 256),
                                       (1, 100, 2257, 200), (4, 300, 100, 256),
                                       (1, 13, 63, 40)])
def test_mask_pool_splits_cover_hw_in_one_wave(b, nn, hw, c):
    splits, chunk = mo.mask_pool_splits(b, nn, hw, c, 132, _Tiles)
    blocks = b * math.ceil(nn / 128) * math.ceil(c / 64)
    assert chunk % 32 == 0
    assert (splits - 1) * chunk < hw <= splits * chunk
    assert splits == 1 or blocks * splits <= 132
