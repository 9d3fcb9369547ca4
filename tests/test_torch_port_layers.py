"""Port parity: the three XLA-matching helpers, the layers, ResNet-50 + FPN and
the Semantic FPN, each held against its JAX counterpart on the CPU.

Tolerances: float32 convolutions and matmuls in XLA and in PyTorch sum in
different orders, so outputs agree to ~1e-6 relative per layer; a stated
relative bound (max abs error over max abs value) covers the depth of each
stack. Index-valued resizes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_common import assert_rel_close, n, perturb_norms, port_of, t

from video_knet_tpu.models import layers as jl
from video_knet_tpu.models.resnet import FPN as JFPN
from video_knet_tpu.models.resnet import ResNet as JResNet
from video_knet_tpu.models.semantic_fpn import SemanticFPN as JSemanticFPN
from video_knet_tpu_torch.models import layers as tl
from video_knet_tpu_torch.models.resnet import FPN, ResNet
from video_knet_tpu_torch.models.semantic_fpn import SemanticFPN

# ------------------------------------------------------------- (a) XLA helpers


@pytest.mark.parametrize("k,s,hw", [(3, 2, (16, 24)), (3, 2, (17, 25)), (7, 2, (32, 40)),
                                    (3, 1, (9, 11)), (1, 2, (15, 16))])
def test_same_padding_conv_matches_xla(k, s, hw):
    rng = np.random.RandomState(k * 10 + s)
    x = rng.randn(1, *hw, 8).astype(np.float32)
    w = rng.randn(k, k, 8, 16).astype(np.float32)
    ref = jax.lax.conv_general_dilated(x, w, (s, s), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = tl.Conv2d(8, 16, k, stride=s, bias=False)
    conv.weight.data = t(w.transpose(3, 2, 0, 1))
    assert_rel_close(conv(t(x)), ref, 1e-6, "SAME conv")
    if s == 2 and k > 1 and hw[0] % 2 == 0:
        # torch's symmetric padding=k//2 shifts the output by one pixel here
        sym = F.conv2d(t(x).permute(0, 3, 1, 2), conv.weight, stride=s, padding=k // 2)
        assert np.abs(n(sym.permute(0, 2, 3, 1)) - np.asarray(ref)).max() > 1.0


@pytest.mark.parametrize("src,dst", [((8, 12), (32, 48)), ((5, 7), (12, 9)),
                                     ((24, 30), (7, 11)), ((4, 6), (8, 12))])
def test_resize_nearest_matches_jax(src, dst):
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 50, size=src).astype(np.int32)
    ref = jax.image.resize(labels, dst, method="nearest")
    np.testing.assert_array_equal(n(tl.resize_nearest(t(labels), dst)), np.asarray(ref))
    feats = rng.randn(2, *src, 3).astype(np.float32)
    ref = jax.image.resize(feats, (2, *dst, 3), method="nearest")
    np.testing.assert_array_equal(n(tl.resize_nearest(t(feats), dst, dims=(1, 2))),
                                  np.asarray(ref))
    # the same as torch's "nearest-exact"
    exact = F.interpolate(t(feats).permute(0, 3, 1, 2), size=dst, mode="nearest-exact")
    np.testing.assert_array_equal(n(exact.permute(0, 2, 3, 1)), np.asarray(ref))


@pytest.mark.parametrize("src,dst", [((6, 8), (12, 16)), ((6, 8), (24, 32)),
                                     ((48, 40), (20, 17)), ((12, 16), (12, 40))])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.RandomState(1)
    x = rng.randn(1, *src, 5).astype(np.float32)
    assert_rel_close(tl.resize_bilinear(t(x), dst), jl.resize_bilinear(x, dst), 1e-5,
                     "resize_bilinear")
    m = rng.randn(2, 3, *src).astype(np.float32)
    assert_rel_close(tl.resize_mask_bilinear(t(m), dst), jl.resize_mask_bilinear(m, dst),
                     1e-5, "resize_mask_bilinear")


# -------------------------------------------------------------------- (b) layers


def _init(module, *args):
    return module.init(jax.random.PRNGKey(0), *args)


def test_conv_norm_act_gn_matches():
    x = np.random.RandomState(2).randn(2, 9, 13, 64).astype(np.float32)
    jm = jl.ConvNormAct(64, 3, stride=2, norm="gn")
    v = perturb_norms(_init(jm, x))
    tm = port_of(tl.ConvNormAct(64, 64, 3, stride=2), v)
    assert_rel_close(tm(t(x)), jm.apply(v, x), 1e-5, "ConvNormAct")


def test_group_norm_two_pass_matches():
    # a large offset makes the one-pass variance lose digits; two-pass does not
    x = (np.random.RandomState(3).randn(2, 5, 7, 64) + 300.0).astype(np.float32)
    jm = jl.GroupNorm32()
    v = perturb_norms(_init(jm, x))
    tm = port_of(tl.GroupNorm(64), {"params": v["params"]["GroupNorm_0"]})
    assert_rel_close(tm(t(x)), jm.apply(v, x), 1e-4, "GroupNorm")


def test_mlp_ffn_match():
    x = np.random.RandomState(4).randn(2, 7, 32).astype(np.float32)
    jm = jl.MLP(num_layers=2, features=32)
    v = perturb_norms(_init(jm, x))
    assert_rel_close(port_of(tl.MLP(2, 32, 32), v)(t(x)), jm.apply(v, x), 1e-5, "MLP")
    jf = jl.FFN(hidden=48, out=32)
    v = perturb_norms(_init(jf, x))
    assert_rel_close(port_of(tl.FFN(32, 48, 32), v)(t(x)), jf.apply(v, x), 1e-5, "FFN")


def test_multi_head_attention_matches_flax():
    from flax import linen as nn

    rng = np.random.RandomState(5)
    q = rng.randn(2, 9, 64).astype(np.float32)
    kv = rng.randn(2, 9, 64).astype(np.float32)
    jm = nn.MultiHeadDotProductAttention(num_heads=8, qkv_features=64)
    v = perturb_norms(_init(jm, q, kv))
    tm = port_of(tl.MultiHeadAttention(64, 8), v)
    assert_rel_close(tm(t(q), t(kv)), jm.apply(v, q, kv), 1e-5, "MHA")


def test_sine_positional_encoding_matches():
    for h, w, f in ((6, 9, 32), (48, 156, 128)):
        assert_rel_close(tl.sine_positional_encoding(h, w, f),
                         jl.sine_positional_encoding(h, w, f), 1e-6, "sine PE")


def test_resnet50_fpn_matches():
    x = np.random.RandomState(6).randn(1, 64, 96, 3).astype(np.float32)
    jr = JResNet(depth=50)
    vr = perturb_norms(_init(jr, x))
    feats = jr.apply(vr, x)
    tr = port_of(ResNet(50), vr)
    with torch.no_grad():
        tfeats = tr(t(x))
    for i, (a, b) in enumerate(zip(tfeats, feats)):
        assert_rel_close(a, b, 1e-4, f"resnet stage {i + 1}")
    jf = JFPN()
    vf = _init(jf, feats)
    tf = port_of(FPN(), vf)
    with torch.no_grad():
        touts = tf([t(f) for f in feats])
    for i, (a, b) in enumerate(zip(touts, jf.apply(vf, feats))):
        assert_rel_close(a, b, 1e-5, f"fpn level {i}")


def test_semantic_fpn_matches():
    rng = np.random.RandomState(7)
    feats = [rng.randn(1, 16 // 2**i, 24 // 2**i, 64).astype(np.float32) for i in range(4)]
    jm = JSemanticFPN(feat_channels=64, out_channels=64)
    v = perturb_norms(_init(jm, feats))
    tm = port_of(SemanticFPN(64, 64, 64), v)
    with torch.no_grad():
        outs = tm([t(f) for f in feats])
    for i, (a, b) in enumerate(zip(outs, jm.apply(v, feats))):
        assert_rel_close(a, b, 1e-5, f"semantic fpn out {i}")


def test_semantic_fpn_ragged_levels_match():
    # H/W not divisible by 32: the levels are bilinearly aligned to level 0
    rng = np.random.RandomState(8)
    shapes = [(18, 26), (9, 13), (5, 7), (3, 4)]
    feats = [rng.randn(1, *s, 64).astype(np.float32) for s in shapes]
    jm = JSemanticFPN(feat_channels=64, out_channels=64)
    v = perturb_norms(_init(jm, feats))
    tm = port_of(SemanticFPN(64, 64, 64), v)
    with torch.no_grad():
        outs = tm([t(f) for f in feats])
    for i, (a, b) in enumerate(zip(outs, jm.apply(v, feats))):
        assert_rel_close(a, b, 1e-5, f"semantic fpn out {i}")


def test_jnp_arrays_convert():
    # jax arrays (not only numpy) are accepted by the converter
    x = jnp.asarray(np.random.RandomState(9).randn(1, 4, 4, 64).astype(np.float32))
    jm = jl.ConvNormAct(64, 1, norm="gn")
    v = _init(jm, x)
    tm = port_of(tl.ConvNormAct(64, 64, 1), v)
    assert_rel_close(tm(t(x)), jm.apply(v, x), 1e-5, "ConvNormAct 1x1")
