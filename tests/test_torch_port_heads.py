"""Port parity of the K-Net heads at narrow widths (C=64, 8 heads, FFN 128):
ConvKernelHead, KernelUpdator, and KernelUpdateHead with and without the
cross-frame link.

Tolerance: 1e-4 relative to each output's scale (a few fp32 layers summed
in another order; the binarized pooling sees the same 0/1 masks because
no logit lies within rounding of 0).
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, perturb_norms, port_of, t

from video_knet_tpu.config import (
    ConvKernelHeadConfig as JRpnCfg,
    KernelUpdateHeadConfig as JHeadCfg,
    KernelUpdatorConfig as JUpdCfg,
)
from video_knet_tpu.models.kernel_head import ConvKernelHead as JConvKernelHead
from video_knet_tpu.models.kernel_update_head import KernelUpdateHead as JKernelUpdateHead
from video_knet_tpu.models.kernel_updator import KernelUpdator as JKernelUpdator
from video_knet_tpu_torch.config import (
    ConvKernelHeadConfig,
    KernelUpdateHeadConfig,
    KernelUpdatorConfig,
)
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead
from video_knet_tpu_torch.models.kernel_update_head import KernelUpdateHead
from video_knet_tpu_torch.models.kernel_updator import KernelUpdator

C = 64
REL = 1e-4


def _head_cfgs():
    kw = dict(in_channels=C, out_channels=C, feedforward_channels=128, num_heads=8,
              mask_upsample_stride=4)
    return (JHeadCfg(updator=JUpdCfg(C, C, C), **kw),
            KernelUpdateHeadConfig(updator=KernelUpdatorConfig(C, C, C), **kw))


def test_kernel_updator_matches():
    rng = np.random.RandomState(0)
    upd = rng.randn(2, 23, C).astype(np.float32)
    inp = rng.randn(2, 23, 1, C).astype(np.float32)
    jm = JKernelUpdator(C, C, C)
    v = perturb_norms(jm.init(jax.random.PRNGKey(0), upd, inp))
    tm = port_of(KernelUpdator(C, C, C), v)
    with torch.no_grad():
        assert_rel_close(tm(t(upd), t(inp)), jm.apply(v, upd, inp), REL, "KernelUpdator")


@pytest.mark.parametrize("with_previous,mask_hw", [(False, (12, 16)), (True, (12, 16)),
                                                   (True, (6, 8))])
def test_kernel_update_head_matches(with_previous, mask_hw):
    jcfg, tcfg = _head_cfgs()
    rng = np.random.RandomState(1)
    x = rng.randn(1, 12, 16, C).astype(np.float32)
    prop = rng.randn(1, 23, 1, C).astype(np.float32)
    masks = rng.randn(1, 23, *mask_hw).astype(np.float32) * 3
    prev = rng.randn(1, 23, 1, C).astype(np.float32)
    jm = JKernelUpdateHead(jcfg, with_previous=with_previous)
    v = perturb_norms(jm.init(jax.random.PRNGKey(1), x, prop, masks,
                              prev if with_previous else None))
    tm = port_of(KernelUpdateHead(tcfg, with_previous=with_previous), v)
    want = jm.apply(v, x, prop, masks, prev if with_previous else None)
    with torch.no_grad():
        got = tm(t(x), t(prop), t(masks), t(prev) if with_previous else None)
    for name, a, b in zip(("cls_score", "mask_preds", "obj_feat", "obj_feat_track"), got, want):
        if b is None:
            assert a is None
        else:
            assert_rel_close(a, b, REL, name)


def test_conv_kernel_head_matches():
    kw = dict(num_proposals=20, in_channels=C, out_channels=C, fpn_feat_channels=C,
              feat_downsample_stride=4)
    rng = np.random.RandomState(2)
    feats = [rng.randn(1, 16 // 2**i, 24 // 2**i, C).astype(np.float32) for i in range(4)]
    jm = JConvKernelHead(JRpnCfg(**kw))
    v = perturb_norms(jm.init(jax.random.PRNGKey(2), feats))
    # the head's input width is the neck's (here C), passed explicitly
    tm = port_of(ConvKernelHead(ConvKernelHeadConfig(**kw), in_channels=C), v)
    want = jm.apply(v, feats)
    with torch.no_grad():
        got = tm([t(f) for f in feats])
    for name in got._fields:
        assert_rel_close(getattr(got, name), getattr(want, name), REL, name)
