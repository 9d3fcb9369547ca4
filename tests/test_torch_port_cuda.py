"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a GPU. This file imports
neither jax nor the JAX package, so it runs where only PyTorch is installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerance: 1e-5 relative to the output's scale (the kernels sum in another
order than cuBLAS); the binarize is exact, so zero logits give exact zeros.
"""

import numpy as np
import pytest
import torch

from video_knet_tpu_torch.ops.kernels import mask_ops as mo

pytestmark = pytest.mark.cuda

# (B, N, H, W, C): ragged N / HW / C; the serving stage shape, at B=1 and 2;
# the init-head shape (N=100); HW that is a multiple of 4 but not of K1's
# 32-wide ring slab or HW split (48x157), and an odd HW (37x61, 4-byte copies)
SHAPES = [(1, 24, 12, 20, 64), (2, 13, 7, 9, 40), (1, 100, 5, 11, 36), (1, 117, 48, 156, 256),
          (2, 117, 48, 156, 256), (1, 100, 48, 156, 256), (1, 117, 48, 157, 200),
          (1, 117, 37, 61, 256)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _logits(rng, shape, dev):
    x = _rand(rng, shape, dev)
    return torch.where(x >= 0, x.clamp(min=1e-6), x.clamp(max=-1e-6))


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("b,n,h,w,c", SHAPES)
def test_kernels_match_plain(dev, b, n, h, w, c):
    rng = np.random.RandomState(n)
    logits = _logits(rng, (b, n, h, w), dev)
    feats = _rand(rng, (b, h, w, c), dev)
    kern = _rand(rng, (b, n, c), dev, 1 / np.sqrt(c))
    mo.reset_launch_counts()
    _close(mo.fused_mask_pool(logits, feats), mo.mask_pool_plain(logits, feats))
    for sig in (False, True):
        _close(mo.fused_assemble(kern, feats, sigmoid=sig),
               mo.assemble_plain(kern, feats, sigmoid=sig))
    torch.cuda.synchronize()
    assert mo.LAUNCHES == {"mask_pool": 1, "assemble": 2}


def test_mask_pool_is_deterministic_and_skips_zero_logits(dev):
    rng = np.random.RandomState(7)
    logits = _logits(rng, (1, 117, 48, 156), dev)
    logits[:, :3] = 0.0  # sigmoid(0) = 0.5 is not > 0.5
    feats = _rand(rng, (1, 48, 156, 256), dev)
    first = mo.fused_mask_pool(logits, feats)
    assert bool((first[:, :3] == 0).all())
    for _ in range(3):
        assert torch.equal(mo.fused_mask_pool(logits, feats), first)


def test_mask_pool_three_plane_split_is_exact(dev):
    """Features over eight decades: a single bf16 (or two-plane) pass would
    miss 1e-6 of the output's scale; the three-plane split only sums in
    another order than the fp64 reference."""
    rng = np.random.RandomState(11)
    logits = _logits(rng, (1, 117, 48, 156), dev)
    mag = 10.0 ** rng.uniform(-4, 4, size=(1, 48, 156, 256))
    feats = torch.from_numpy(np.where(rng.rand(*mag.shape) < 0.5, -mag, mag)
                             .astype(np.float32)).to(dev)
    hard = (torch.sigmoid(logits) > 0.5).double()
    want = torch.einsum("bnhw,bhwc->bnc", hard, feats.double())
    _close(mo.fused_mask_pool(logits, feats).double(), want, rel=1e-6)


def test_wrappers_reject_bad_inputs(dev):
    feats = torch.zeros((1, 4, 4, 8), device=dev)
    with pytest.raises(TypeError):
        mo.fused_mask_pool(torch.zeros((1, 2, 4, 4), device=dev, dtype=torch.float64), feats)
    with pytest.raises(ValueError):
        mo.fused_assemble(torch.zeros((1, 2, 16), device=dev)[:, :, ::2], feats)
    with pytest.raises(ValueError):
        mo.fused_mask_pool(torch.zeros((1, 2, 4, 4)), feats)  # mixed devices
