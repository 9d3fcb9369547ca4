"""The port's MiT backbone (`models/mit.py`) against the JAX package, on the CPU.

MixVisionTransformer b0 with perturbed norms, all four stage outputs within
1e-5 relative, at 64x96 and at 52x76, whose stage-0 map (13x19) is not a
multiple of the spatial-reduction ratio 8, so the "SAME" padding of the
`sr` conv shows. Also the pieces with their own traps: flax's fast-variance
LayerNorm, the depthwise conv's converted weight layout, and the neck
widths the backbone gives the FPN and the head.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch_port_common import assert_rel_close, perturb_norms, port_of, t

from video_knet_tpu.models.mit import MixFFN as JMixFFN
from video_knet_tpu.models.mit import MixVisionTransformer as JMiT
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch.models.layers import FastVarianceLayerNorm
from video_knet_tpu_torch.models.mit import MIT_PRESETS, MixFFN, MixVisionTransformer
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet


@pytest.mark.parametrize("hw", [(64, 96), (52, 76)])
def test_mit_b0_matches_jax(hw):
    x = np.random.RandomState(0).randn(1, *hw, 3).astype(np.float32)
    jm = JMiT("b0")
    variables = perturb_norms(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))))
    want = jm.apply(variables, x)
    model = port_of(MixVisionTransformer("b0"), variables)
    with torch.no_grad():
        got = model(t(x))
    assert len(got) == 4
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape[-1] == MIT_PRESETS["b0"][0][s]
        assert_rel_close(a, b, 1e-5, f"stage {s}")


def test_fast_variance_layer_norm_matches_flax():
    rng = np.random.RandomState(1)
    x = (3.0 + rng.randn(4, 7, 48)).astype(np.float32)  # a mean far from 0
    ln = fnn.LayerNorm(epsilon=1e-6)
    variables = perturb_norms(ln.init(jax.random.PRNGKey(0), x))
    want = ln.apply(variables, x)
    got = port_of(FastVarianceLayerNorm(48, eps=1e-6), variables)(t(x))
    assert_rel_close(got.detach(), want, 1e-5, "layer norm")


def test_mix_ffn_depthwise_conv_layout():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6 * 10, 16).astype(np.float32)
    jm = JMixFFN(16, 64)
    variables = jm.init(jax.random.PRNGKey(1), x, (6, 10))
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.1 * np.asarray(jax.random.normal(jax.random.PRNGKey(2), v.shape)),
        variables)
    model = port_of(MixFFN(16, 64), variables)
    assert tuple(model.dwconv.weight.shape) == (64, 1, 3, 3)
    with torch.no_grad():
        got = model(t(x), (6, 10))
    assert_rel_close(got, jm.apply(variables, x, (6, 10)), 1e-5, "mix ffn")


@pytest.mark.parametrize("backbone,widths", [("resnet50", (256, 512, 1024, 2048)),
                                             ("mit_b0", (32, 64, 160, 256))])
def test_neck_and_head_widths_follow_the_backbone(backbone, widths):
    """The FPN takes the backbone's stage widths and the head's localization
    FPN the neck's 256, whatever `cfg.rpn.in_channels` says."""
    base = tc.VideoKNetConfig()
    cfg = dataclasses.replace(base, backbone=backbone,
                              rpn=dataclasses.replace(base.rpn, in_channels=64))
    model = VideoKNet(cfg, device="cpu")
    assert tuple(model.neck.lateral0.weight.shape[:2]) == (256, widths[0])
    assert tuple(model.neck.lateral3.weight.shape[:2]) == (256, widths[3])
    assert model.rpn_head.localization_fpn.l1_conv0.Conv_0.weight.shape[1] == 256
    with torch.no_grad():
        out = model.test_step(torch.zeros(1, 64, 96, 3), torch.zeros(1, 117, 1, 256), True)
    assert torch.isfinite(out["track_embeds"]).all()
