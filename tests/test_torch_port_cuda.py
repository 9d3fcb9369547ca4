"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a GPU. This file imports
neither jax nor the JAX package, so it runs where only PyTorch is installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerance: 1e-5 relative to the output's scale (the kernels sum in another
order than cuBLAS, and K2's 3xTF32 product leaves ~2^-21 of each term);
the binarize is exact, so zero logits give exact zeros.
"""

import os

import numpy as np
import pytest
import torch

from video_knet_tpu_torch.ops.kernels import mask_ops as mo
from video_knet_tpu_torch.utils.device import set_fp32_numerics

pytestmark = pytest.mark.cuda

# (B, N, H, W, C): ragged N / HW / C; the serving stage shape, at B=1 and 2;
# the init-head shape (N=100); HW that is a multiple of 4 but not of K1's
# 32-wide ring slab or HW split (48x157), an odd HW (37x61, 4-byte copies),
# and C = 37, not a multiple of 4 (K1's 4-byte copies; K2's wrapper pads C to 40);
# the trained tiny config's stage shape (N=37, 8x12, C=64), at B=1 and 2;
# Swin-B VIP-Seg's stage shape (N=166 = 100 + 66, 92x160 at 736x1280) and
# its init head's at B=2 (the train step's joint pass); VIS's stage shape
# (a clip's 5 frames folded into the batch, N=100, 45x80 at 360x640);
# COCO panoptic's (N=153 = 100 + 53, 100x168 at 800x1344) and the image
# train step's (B=8, N=117, 64x128 at 512x1024)
SHAPES = [(1, 24, 12, 20, 64), (2, 13, 7, 9, 40), (1, 100, 5, 11, 36), (1, 117, 48, 156, 256),
          (2, 117, 48, 156, 256), (1, 100, 48, 156, 256), (1, 117, 48, 157, 200),
          (1, 117, 37, 61, 256), (1, 100, 37, 61, 37), (1, 37, 8, 12, 64), (2, 37, 8, 12, 64),
          (1, 166, 92, 160, 256), (2, 100, 92, 160, 256), (5, 100, 45, 80, 256),
          (1, 153, 100, 168, 256), (8, 117, 64, 128, 256)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    set_fp32_numerics()  # cuBLAS and cuDNN in fp32, whatever an earlier test left
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


def _wide(rng, shape, dev):
    """Magnitudes over 1e-4 .. 1e4 with random signs."""
    mag = 10.0 ** rng.uniform(-4, 4, size=shape)
    return torch.from_numpy(np.where(rng.rand(*shape) < 0.5, -mag, mag)
                            .astype(np.float32)).to(dev)


def test_assemble_3xtf32_mixed_magnitude(dev):
    """Kernels and features over eight decades: the 3xTF32 product stays
    within 1e-5 of the output's scale against an fp64 einsum, as cuBLAS's
    fp32 product does (both errors printed)."""
    rng = np.random.RandomState(13)
    kern = _wide(rng, (1, 117, 256), dev)
    feats = _wide(rng, (1, 48, 156, 256), dev)
    want = torch.einsum("bnc,bhwc->bnhw", kern.double(), feats.double())
    scale = float(want.abs().max())
    got = mo.fused_assemble(kern, feats).double()
    cublas = mo.assemble_plain(kern, feats).double()
    err, err_cublas = (float((x - want).abs().max()) / scale for x in (got, cublas))
    print(f"K2 max abs err / scale vs fp64: {err:.3e}; cuBLAS fp32 {err_cublas:.3e}")
    assert err <= 1e-5


@pytest.mark.parametrize("sigmoid", [False, True])
def test_assemble_is_deterministic(dev, sigmoid):
    rng = np.random.RandomState(9)
    feats = _rand(rng, (1, 48, 156, 256), dev)
    kern = _rand(rng, (1, 117, 256), dev, 1 / 16)
    first = mo.fused_assemble(kern, feats, sigmoid=sigmoid)
    for _ in range(3):
        assert torch.equal(mo.fused_assemble(kern, feats, sigmoid=sigmoid), first)


# (B, N, H, W, C) for the gradients: the serving stage shape, a ragged one
# with C = 37 (K2's wrapper pads C to 40 inside its autograd Function), the
# init head's N = 100 at B = 2 (the train step's joint [ref; key] pass), and
# Swin-B VIP-Seg's stage shape
GRAD_SHAPES = [(1, 117, 48, 156, 256), (2, 13, 7, 9, 37), (2, 100, 48, 156, 256),
               (5, 100, 45, 80, 256),
               (1, 166, 92, 160, 256)]


@pytest.mark.parametrize("b,n,h,w,c", GRAD_SHAPES)
def test_mask_pool_gradient_matches_plain_autograd(dev, b, n, h, w, c):
    """d feats = hard^T . d out from the forward's own mask words; the
    logits take no gradient (the hard threshold), as in the plain version."""
    rng = np.random.RandomState(n + c)
    logits = _logits(rng, (b, n, h, w), dev).requires_grad_()
    feats = _rand(rng, (b, h, w, c), dev)
    d_out = _rand(rng, (b, n, c), dev)
    f1, f2 = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    mo.reset_launch_counts()
    (mo.fused_mask_pool(logits, f1) * d_out).sum().backward()
    assert mo.LAUNCHES == {"mask_pool": 1, "assemble": 0}  # forward launches only
    (mo.mask_pool_plain(logits, f2) * d_out).sum().backward()
    assert logits.grad is None
    _close(f1.grad, f2.grad)


@pytest.mark.parametrize("sigmoid", [False, True])
@pytest.mark.parametrize("b,n,h,w,c", GRAD_SHAPES)
def test_assemble_gradients_match_plain_autograd(dev, b, n, h, w, c, sigmoid):
    rng = np.random.RandomState(n + c + sigmoid)
    kern = _rand(rng, (b, n, c), dev, 1 / np.sqrt(c))
    feats = _rand(rng, (b, h, w, c), dev)
    d_out = _rand(rng, (b, n, h, w), dev)
    k1, k2 = kern.clone().requires_grad_(), kern.clone().requires_grad_()
    f1, f2 = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    mo.reset_launch_counts()
    (mo.fused_assemble(k1, f1, sigmoid=sigmoid) * d_out).sum().backward()
    assert mo.LAUNCHES == {"mask_pool": 0, "assemble": 1}
    (mo.assemble_plain(k2, f2, sigmoid=sigmoid) * d_out).sum().backward()
    assert k1.grad.shape == kern.shape and f1.grad.shape == feats.shape
    _close(k1.grad, k2.grad)
    _close(f1.grad, f2.grad)


def test_hungarian_kernel_matches_numpy_copy(dev):
    from video_knet_tpu_torch.ops import hungarian as hung
    from video_knet_tpu_torch.ops.kernels import hungarian as hk

    hk.reset_launch_counts()
    for costs, valid in hk.tie_heavy_problems(seed=2):
        got = hk.solve(torch.from_numpy(costs).to(dev))
        np.testing.assert_array_equal(got.cpu().numpy(), hk.hungarian_plain(costs))
        cost = torch.from_numpy(np.ascontiguousarray(costs.transpose(0, 2, 1)))
        for a, b in zip(hung.pad_and_solve(cost.to(dev), torch.from_numpy(valid).to(dev)),
                        hung.pad_and_solve(cost, torch.from_numpy(valid))):
            assert torch.equal(a.cpu(), b)
    assert hk.LAUNCHES["hungarian"] == 6  # one a solve: 3 shapes, direct and padded


def test_train_step_on_the_card_matches_the_cpu(dev):
    """A 64x96 train step: the card's gradients equal the CPU's (which the
    CPU tests hold against JAX) leaf by leaf, so every gradient through K1
    and K2 arrives; each mask kernel launches 7 times and the Hungarian
    kernel once."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.ops.kernels import hungarian as hk
    from video_knet_tpu_torch.tools.train_check import margin_seed
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step

    cfg = VideoKNetConfig(max_insts=4)
    seed, _ = margin_seed(cfg, (64, 96))
    # a caller with TF32 on: the entry point must turn it off for the step
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    grads, losses = {}, {}
    for d in (dev, torch.device("cpu")):
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device=d)
        state = create_train_state(model, make_optimizer(model, 1000))
        batch = make_synthetic_batch(cfg, 1, (64, 96), seed=0, device=d)
        mo.reset_launch_counts()
        hk.reset_launch_counts()
        state, out = train_step(state, batch)
        if d.type == "cuda":
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            assert mo.LAUNCHES == {"mask_pool": 7, "assemble": 7}
            assert hk.LAUNCHES == {"hungarian": 1}
        grads[d.type] = {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.requires_grad}
        losses[d.type] = {k: float(v) for k, v in out.items()}
    for k, want in losses["cpu"].items():
        assert abs(losses["cuda"][k] - want) <= 1e-4 * max(abs(want), 1e-6), k
    for k, want in grads["cpu"].items():
        scale = float(want.abs().max())
        if k.endswith("key.bias"):  # zero up to rounding: softmax ignores it
            scale = float(grads["cpu"][k[:-len("bias")] + "weight"].abs().max())
        assert scale > 0, k
        assert float((grads["cuda"][k] - want).abs().max()) <= 1e-3 * scale, k


def test_swin_on_the_card_matches_the_cpu(dev):
    """Swin-tiny at 64x96 (shifted windows and their mask in stages 0 and 1,
    odd patch merging below): the card's four outputs within 1e-5 of the
    CPU's scale (fp32, TF32 off), and its stochastic depth draws from a
    generator on the card."""
    from video_knet_tpu_torch.models.layers import init_parameters
    from video_knet_tpu_torch.models.swin import SwinTransformer

    model = SwinTransformer("tiny", drop_path_rate=0.3)
    init_parameters(model, torch.Generator().manual_seed(0))
    img = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(img)
        got = model.to(dev)(img.to(dev))
        dropped = model(img.to(dev).expand(4, -1, -1, -1),
                        torch.Generator(device=dev).manual_seed(0))
    for a, b in zip(got, want):
        _close(a.cpu(), b)
    assert all(bool(torch.isfinite(d).all()) for d in dropped)


def test_vis_clip_on_the_card_matches_the_cpu(dev):
    """The tiny VIS config (`train_check.vis_check_cfg`, T=2, 64x96; weights
    from `vis_margin_seed`): the card's forward outputs within 1e-4 of the
    CPU's scale and the decode's integer fields equal, with 7 launches of
    each mask kernel; then one train step: losses within 1e-4, gradients
    within 1e-3 of each leaf's scale (the CPU's step replaying the card's
    ReLU decisions), 7 / 7 mask-kernel launches and one Hungarian launch."""
    from video_knet_tpu_torch.config_vis import VISConfig
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS, vis_decode
    from video_knet_tpu_torch.ops.kernels import hungarian as hk
    from video_knet_tpu_torch.tools.train_check import (
        relu_pattern,
        vis_check_cfg,
        vis_margin_seed,
    )
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vis import make_synthetic_batch, train_step

    cfg = vis_check_cfg(VISConfig())
    seed, _ = vis_margin_seed(cfg, (64, 96))
    runs, pattern = {}, []
    for d in (dev, torch.device("cpu")):
        model = KNetVIS(cfg, generator=torch.Generator().manual_seed(seed), device=d)
        batch = make_synthetic_batch(cfg, 1, (64, 96), seed=0, device=d)
        mo.reset_launch_counts()
        with torch.no_grad():
            outs = model(batch.clip)
            pred = vis_decode(outs, cfg, out_hw=(64, 96))
        if d.type == "cuda":
            assert mo.LAUNCHES == {"mask_pool": 7, "assemble": 7}
        mo.reset_launch_counts()
        hk.reset_launch_counts()
        # the CPU's step follows the card's ReLU decisions (train_check.relu_pattern)
        with relu_pattern(pattern, replay=d.type == "cpu"):
            state, losses = train_step(create_train_state(model, make_optimizer(model, 1000)),
                                       batch)
        if d.type == "cuda":
            assert mo.LAUNCHES == {"mask_pool": 7, "assemble": 7}
            assert hk.LAUNCHES == {"hungarian": 1}
        stages = outs.frame_stage_outs + outs.clip_stage_outs
        runs[d.type] = dict(
            masks=[s.mask_preds.cpu() for s in stages], pred=[x.cpu() for x in pred],
            losses={k: float(v) for k, v in losses.items()},
            grads={n: p.grad.cpu() for n, p in model.named_parameters()})
    g, c = runs["cuda"], runs["cpu"]
    for a, b in zip(g["masks"], c["masks"]):
        _close(a, b, 1e-4)
    for f in (1, 3):  # labels, track ids
        assert torch.equal(g["pred"][f], c["pred"][f])
    _close(g["pred"][0], c["pred"][0], 1e-4)
    for k, want in c["losses"].items():
        assert abs(g["losses"][k] - want) <= 1e-4 * max(abs(want), 1e-6), k
    for k, want in c["grads"].items():
        scale = float(want.abs().max())
        if k.endswith("key.bias"):  # zero up to rounding: softmax ignores it
            scale = float(c["grads"][k[:-len("bias")] + "weight"].abs().max())
        assert float((g["grads"][k] - want).abs().max()) <= 1e-3 * max(scale, 1e-12), k


def test_image_knet_on_the_card_matches_the_cpu(dev):
    """The tiny image config (`train_check.image_check_cfg`: MiT-b0,
    64-channel heads, the MSDeformAttn neck at one encoder layer; weights
    from `image_margin_seed`), panoptic and instance: the card's forward
    within 1e-4 of the CPU's scale with 4 launches of each mask kernel, the
    decodes' integer fields equal; one panoptic train step: losses within
    1e-4, gradients within 1e-3 of each leaf's scale (the CPU's step
    replaying the card's ReLU decisions), 4 / 4 / 1 launches."""
    from video_knet_tpu_torch.config import KNetConfig
    from video_knet_tpu_torch.models import knet as tk
    from video_knet_tpu_torch.ops.kernels import hungarian as hk
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.train.image import make_synthetic_batch, train_step
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state

    for instance in (False, True):
        cfg = train_check.image_check_cfg(KNetConfig(), instance=instance)
        seed, _ = train_check.image_margin_seed(cfg, (64, 96))
        runs, pattern = [], []
        for d in (dev, torch.device("cpu")):
            model = train_check.image_check_model(cfg, seed, d)
            batch = make_synthetic_batch(cfg, 1, (64, 96), seed=0, device=d)
            mo.reset_launch_counts()
            with torch.no_grad():
                rpn_out, stages = model(batch.img)
                pred = (tk.instance_decode(rpn_out, stages, cfg, out_hw=(64, 96)).labels
                        if instance else tk.panoptic_decode(rpn_out, stages, cfg,
                                                            out_hw=(64, 96)).result.panoptic_seg)
            if d.type == "cuda":
                assert mo.LAUNCHES == {"mask_pool": 4, "assemble": 4}
            run = dict(masks=[s.mask_preds.cpu() for s in stages], pred=pred.cpu())
            if not instance:
                mo.reset_launch_counts()
                hk.reset_launch_counts()
                with train_check.relu_pattern(pattern, replay=bool(runs)):
                    _, losses = train_step(create_train_state(model, make_optimizer(model, 1000)),
                                           batch)
                if d.type == "cuda":
                    assert mo.LAUNCHES == {"mask_pool": 4, "assemble": 4}
                    assert hk.LAUNCHES == {"hungarian": 1}
                run.update(losses={k: float(v) for k, v in losses.items()},
                           grads={n: p.grad.cpu() for n, p in model.named_parameters()})
            runs.append(run)
        g, c = runs
        for a, b in zip(g["masks"], c["masks"]):
            _close(a, b, 1e-4)
        assert torch.equal(g["pred"], c["pred"])
        if instance:
            continue
        for k, want in c["losses"].items():
            assert abs(g["losses"][k] - want) <= 1e-4 * max(abs(want), 1e-6), k
        for k, want in c["grads"].items():
            scale = float(want.abs().max())
            if k.endswith("key.bias"):  # zero up to rounding: softmax ignores it
                scale = float(c["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((g["grads"][k] - want).abs().max()) <= 1e-3 * max(scale, 1e-12), k


def test_ms_deform_attn_core_on_the_card_matches_the_cpu(dev):
    """The MSDeformAttn sampling (plain PyTorch gathers) at VIS's deformable
    shape (5 frames' levels 45x80, 23x40, 12x20; 8 heads of 32, 4 points),
    a sixth of the points off the map: the card's forward within 1e-6 of
    the CPU's in fp32 (the same arithmetic), its gradients within 1e-5 (the
    card's gather backward accumulates with atomics, in another order)."""
    from video_knet_tpu_torch.ops.sampling import ms_deform_attn_core

    gen = torch.Generator().manual_seed(0)
    shapes = [(45, 80), (23, 40), (12, 20)]
    q = sum(h * w for h, w in shapes)
    values = [torch.randn(5, h, w, 8, 32, generator=gen) for h, w in shapes]
    locs = torch.rand(5, q, 8, 3, 4, 2, generator=gen) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(5, q, 8, 12, generator=gen), -1).reshape(5, q, 8, 3, 4)
    cot = torch.randn(5, q, 256, generator=gen)
    runs = []
    for d in (dev, torch.device("cpu")):
        vs = [v.to(d).requires_grad_() for v in values]
        lc, at = locs.to(d).requires_grad_(), attn.to(d).requires_grad_()
        out = ms_deform_attn_core(vs, lc, at)
        (out * cot.to(d)).sum().backward()
        runs.append([out.detach().cpu(), lc.grad.cpu(), at.grad.cpu()]
                    + [v.grad.cpu() for v in vs])
    for i, (a, b) in enumerate(zip(*runs)):
        _close(a, b, 1e-6 if i == 0 else 1e-5)


def test_roi_align_on_the_card_matches_the_cpu(dev):
    """`roi_align` (plain PyTorch gathers) at the RoI head's serve shape: 100
    boxes (some across the edges, some off the map, some empty) over a
    96x312 mask grid, sampled from 48x156x256 features; and its gradient."""
    from video_knet_tpu_torch.ops.sampling import roi_align

    rng = np.random.RandomState(0)
    feat = rng.randn(48, 156, 256).astype(np.float32)
    xy = rng.uniform(-20, 320, (100, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 80, (100, 2))], axis=1).astype(np.float32)
    rois[:5] = 0.0
    weight = torch.from_numpy(rng.randn(100, 7, 7, 256).astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        f = torch.from_numpy(feat).to(d).requires_grad_()
        y = roi_align(f, torch.from_numpy(rois).to(d), spatial_scale=0.5)
        (y * weight.to(d)).sum().backward()
        out[d.type] = (y.detach().cpu(), f.grad.cpu())
    _close(out["cuda"][0], out["cpu"][0])
    _close(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("head", ["query_fuse", "roi_gt_box"])
def test_track_heads_on_the_card_match_the_cpu(dev, head):
    """The tiny check config with the fuse-track or RoI GT-box head
    (`train_check.track_check_cfg`, margin-seed weights): the test step's
    track embeddings and logits on the card within 1e-4 of the CPU's scale,
    4 launches of each mask kernel; the train forward's embeddings too, 7
    launches of each (no ReLU replay: the train forward's embeddings sit
    behind the heads' ReLUs, whose inputs the margin seed keeps clear here)."""
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.train.vps import make_synthetic_batch

    cfg = train_check.track_check_cfg(tg.tiny_cfg(), head)
    seed, _ = train_check.margin_seed(cfg, (64, 96))
    runs = {}
    for d in (dev, torch.device("cpu")):
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device=d)
        batch = make_synthetic_batch(cfg, 1, (64, 96), seed=0, device=d)
        prev = torch.zeros((1, cfg.num_proposals + cfg.num_stuff_classes, 1, 64), device=d)
        mo.reset_launch_counts()
        with torch.no_grad():
            out = model.test_step(batch.img, prev, True)
        if d.type == "cuda":
            assert mo.LAUNCHES == {"mask_pool": 4, "assemble": 4}
        mo.reset_launch_counts()
        with torch.no_grad():
            _, _, ke, re = model.forward_train(batch.img, batch.ref_img, None, batch.gt.masks,
                                               batch.ref_gt.masks)
        if d.type == "cuda":
            assert mo.LAUNCHES == {"mask_pool": 7, "assemble": 7}
        runs[d.type] = [x.cpu() for x in (out["track_embeds"], out["stage_outs"][-1].cls_score,
                                          out["stage_outs"][-1].mask_preds, ke, re)]
    for name, g, c in zip(("track_embeds", "cls", "masks", "key_embeds", "ref_embeds"),
                          runs["cuda"], runs["cpu"]):
        err = float((g - c).abs().max() / c.abs().max().clamp(min=1e-6))
        assert err <= 1e-4, (head, name, err)


def test_image_and_vis_models_turn_tf32_off(dev):
    """`KNet` and `KNetVIS` built on CUDA hold cuBLAS and cuDNN to fp32, as
    the VPS pipeline and the train entry points do, whatever the caller had
    set."""
    from video_knet_tpu_torch.config import KNetConfig
    from video_knet_tpu_torch.config_vis import VISConfig
    from video_knet_tpu_torch.models.knet import KNet
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
    from video_knet_tpu_torch.tools import train_check

    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    for build in (lambda: KNet(train_check.image_check_cfg(KNetConfig()), device=dev),
                  lambda: KNetVIS(train_check.vis_check_cfg(VISConfig()), device=dev)):
        for f in flags:
            f.allow_tf32 = True
        build()
        assert [f.allow_tf32 for f in flags] == [False, False]


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """Two steps of the trained tiny config on the card, saved, restored
    into a model and optimizer built from another seed: parameters, AdamW
    moments, step and learning rates bit-equal; the next step's losses
    equal from either state."""
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step
    from video_knet_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = tg.tiny_cfg()

    def fresh(seed):
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
        return create_train_state(model, make_optimizer(model, 1000))

    batches = [make_synthetic_batch(cfg, 1, (64, 96), seed=i, device=dev) for i in range(3)]
    state = fresh(0)
    for b in batches[:2]:
        state, _ = train_step(state, b)
    path = save_checkpoint(str(tmp_path), state, step=state.step)
    restored = restore_checkpoint(path, fresh(1))
    assert restored.step == state.step == 2
    for (n, p), (_, q) in zip(state.model.state_dict().items(),
                              restored.model.state_dict().items()):
        assert q.device == p.device and torch.equal(p, q), n
    for a, b in zip(state.optimizer.adamw.param_groups, restored.optimizer.adamw.param_groups):
        assert a["lr"] == b["lr"]
        for p, q in zip(a["params"], b["params"]):
            sa, sb = state.optimizer.adamw.state[p], restored.optimizer.adamw.state[q]
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[k].cpu(), sb[k].cpu()), k
    _, want = train_step(state, batches[2])
    _, got = train_step(restored, batches[2])
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


def test_reference_import_serves_on_the_card(dev):
    """A synthetic reference-named joint-train state dict at the release
    widths, imported strictly into the default VideoKNet on the card, every
    tensor bit-equal to the import; one 384x1248 frame served on the device
    tracker with 4 launches of each mask kernel."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.tools.reference_sd import add_joint_train_sd, build_reference_sd
    from video_knet_tpu_torch.utils.checkpoint import image_to_video_params
    from video_knet_tpu_torch.utils.torch_import import import_torch_knet

    gen = torch.Generator().manual_seed(0)
    sd = add_joint_train_sd(build_reference_sd(gen), gen)
    imported = image_to_video_params(import_torch_knet(sd, strict=True))
    cfg = VideoKNetConfig()
    model = VideoKNet(cfg, device=dev)
    model.load_state_dict(imported, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v.cpu(), imported[k]), k
    pipe = VPSInferencePipeline(model, cfg, (384, 1248), device=dev)
    frame = torch.from_numpy(np.random.RandomState(0).randn(1, 384, 1248, 3).astype(np.float32))
    mo.reset_launch_counts()
    res = pipe.run_frame(frame.to(dev), is_first=True)
    assert mo.LAUNCHES == {"mask_pool": 4, "assemble": 4}
    assert res.panoptic_seg.shape == (384, 1248)


def test_png_codec_builds_and_round_trips(dev, tmp_path):
    """g++ alone builds the port's PNG codec here; its own writer's gray,
    RGB and 16-bit files read back bit-equal, without PIL."""
    from video_knet_tpu_torch.data.panoptic_png import load_png, save_png
    from video_knet_tpu_torch.native import build

    build.load_library()
    assert os.path.exists(build.library_path())
    rng = np.random.RandomState(0)
    for i, arr in enumerate((rng.randint(0, 256, (37, 61)).astype(np.uint8),
                             rng.randint(0, 256, (375, 1242, 3)).astype(np.uint8),
                             rng.randint(0, 65536, (20, 33)).astype(np.uint16))):
        path = str(tmp_path / f"{i}.png")
        save_png(path, arr)
        got = load_png(path)
        assert got.dtype == arr.dtype and np.array_equal(got, arr)


@pytest.mark.parametrize("threads", [1, 3])
def test_loader_on_the_card_matches_the_cpu(dev, tmp_path, threads):
    """`VPSTrainLoader` on CUDA yields CUDA tensors equal, field for field,
    to the `device="cpu"` loader's batches."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.data import KittiStepDVPS, VPSTrainLoader
    from video_knet_tpu_torch.tools.data_check import write_kitti_step_tree

    write_kitti_step_tree(str(tmp_path), n_seqs=2, n_frames=3, hw=(60, 94), n_things=6)
    ds = KittiStepDVPS(str(tmp_path), ref_seq_index=(-1, 1))
    cfg = VideoKNetConfig(max_insts=8)
    mk = lambda d: VPSTrainLoader(ds, cfg, batch_size=2, crop_hw=(64, 96), seed=3,  # noqa: E731
                                  num_threads=threads, device=d)
    card, cpu = list(mk(dev)), list(mk("cpu"))
    assert len(card) == len(cpu) == 3
    for a, b in zip(card, cpu):
        pairs = [(a.img, b.img), (a.ref_img, b.ref_img), *zip(a.gt, b.gt), *zip(a.ref_gt, b.ref_gt)]
        for x, y in pairs:
            assert x.device.type == "cuda" and y.device.type == "cpu"
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y)


def _run_test_step(argv, tiny_cfg):
    """The port's `test_step` CLI in process under the trained tiny config."""
    import video_knet_tpu_torch.config as tconfig
    from video_knet_tpu_torch.tools import test_step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "kitti_step_video_config", tiny_cfg)
        test_step.main(argv)


def _pngs(root):
    from video_knet_tpu_torch.data.panoptic_png import load_png

    return {os.path.relpath(os.path.join(d, f), root): load_png(os.path.join(d, f))
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")}


def test_cli_step_on_the_card_matches_the_cpu(dev, tmp_path):
    """`test_step` with the trained tiny model (its committed checkpoint
    saved as a port checkpoint) over its 12 frames as a KITTI-STEP tree: on
    the card (no `--device`) and with `--device cpu`, every `_cat`, `_ins`
    and `final` map equal, 4 launches of each mask kernel a frame."""
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.utils.checkpoint import save_checkpoint

    tree = tg.write_sequence(str(tmp_path / "data"))
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), tg.tiny_model("cpu"))
    argv = ["--data-root", tree, "--split", "train", "--backbone", "mit_b0", "--size", "64",
            "96", "--checkpoint", ckpt]
    mo.reset_launch_counts()
    _run_test_step([*argv, "--out", str(tmp_path / "card")], tg.tiny_cfg)
    torch.cuda.synchronize()
    assert mo.LAUNCHES == {"mask_pool": 4 * tg.N_FRAMES, "assemble": 4 * tg.N_FRAMES}
    _run_test_step([*argv, "--out", str(tmp_path / "cpu"), "--device", "cpu"], tg.tiny_cfg)
    card, cpu = _pngs(str(tmp_path / "card")), _pngs(str(tmp_path / "cpu"))
    assert sorted(card) == sorted(cpu) and len(card) == 3 * tg.N_FRAMES
    for k in cpu:
        assert card[k].dtype == cpu[k].dtype and np.array_equal(card[k], cpu[k]), k


def test_tta_on_the_card_matches_the_cpu(dev):
    """`make_tta_semantic_fn` (scales 0.75 / 1.0 / 1.25, flip) with the
    trained tiny model over its 12 frames: fused logits within 1e-4 of the
    CPU's (relative to their scale), fused maps equal but at pixels whose
    CPU logits are within twice that difference of a tie; 4 launches of each
    mask kernel a variant."""
    from video_knet_tpu_torch.data.tta import make_tta_semantic_fn, near_ties
    from video_knet_tpu_torch.tools import trained_golden as tg

    card, cpu = (make_tta_semantic_fn(tg.tiny_model(d), tg.tiny_cfg(), tg.HW, (0.75, 1.0, 1.25),
                                      flip=True, device=d) for d in (dev, "cpu"))
    for rgb in tg.sequence_images():
        mo.reset_launch_counts()
        a = card.logits(rgb)
        assert mo.LAUNCHES == {"mask_pool": 24, "assemble": 24}
        b = cpu.logits(rgb)
        err = float(np.abs(a - b).max())
        assert err <= 1e-4 * float(np.abs(b).max())
        differ = card(rgb) != cpu(rgb)
        assert not (differ & ~near_ties(b, err)).any()
