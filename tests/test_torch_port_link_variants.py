"""The cross-frame link variants of `KernelUpdateHead` against the JAX package.

All nine pairs of `previous_type` (how the tracking kernels are made:
'ffn', 'update', 'update_obj') and `previous_link` (how the proposal
kernels are rewritten before the update: None, 'link_atten',
'update_dynamic_cov'), at C=64, N=20, an 8x12 map, with perturbed norms
and the same flax variables. Each runs twice: against random previous
kernels, and against zeros, as a sequence's first frame does. Every output
within 1e-5 relative of JAX's. The variant's submodules carry the flax
names, so the strict converter places every leaf.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, perturb_norms, port_of, t

from video_knet_tpu.config import KernelUpdateHeadConfig as JHeadCfg
from video_knet_tpu.config import KernelUpdatorConfig as JUpdCfg
from video_knet_tpu.models.kernel_update_head import KernelUpdateHead as JKernelUpdateHead
from video_knet_tpu_torch.config import KernelUpdateHeadConfig, KernelUpdatorConfig
from video_knet_tpu_torch.models.kernel_update_head import KernelUpdateHead
from video_knet_tpu_torch.models.layers import init_parameters

C, N, HW = 64, 20, (8, 12)
REL = 1e-5
TYPES = ("ffn", "update", "update_obj")
LINKS = (None, "link_atten", "update_dynamic_cov")
OUTPUTS = ("cls_score", "mask_preds", "obj_feat", "obj_feat_track")


def _cfg(head_cfg, upd_cfg):
    return head_cfg(in_channels=C, out_channels=C, feedforward_channels=256, num_heads=8,
                    mask_upsample_stride=4, updator=upd_cfg(C, C, C))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return dict(
        x=rng.randn(1, *HW, C).astype(np.float32),
        prop=rng.randn(1, N, 1, C).astype(np.float32),
        masks=(3 * rng.randn(1, N, *HW)).astype(np.float32),
        prev=rng.randn(1, N, 1, C).astype(np.float32),
    )


@pytest.mark.parametrize("previous_type,previous_link", list(itertools.product(TYPES, LINKS)))
def test_link_variant_matches_jax(inputs, previous_type, previous_link):
    x, prop, masks, prev = (inputs[k] for k in ("x", "prop", "masks", "prev"))
    jm = JKernelUpdateHead(_cfg(JHeadCfg, JUpdCfg), with_previous=True,
                           previous_type=previous_type, previous_link=previous_link)
    # eager: at this size op-by-op dispatch is quicker than nine compiles
    variables = perturb_norms(jm.init(jax.random.PRNGKey(1), x, prop, masks, prev))
    tm = port_of(KernelUpdateHead(_cfg(KernelUpdateHeadConfig, KernelUpdatorConfig),
                                  with_previous=True, previous_type=previous_type,
                                  previous_link=previous_link), variables)
    for what, p in (("previous", prev), ("zero previous", np.zeros_like(prev))):
        want = jm.apply(variables, x, prop, masks, jnp.asarray(p))
        with torch.no_grad():
            got = tm(t(x), t(prop), t(masks), t(p))
        for name, a, b in zip(OUTPUTS, got, want):
            assert_rel_close(a, b, REL, f"{what}: {name}")


def test_link_rewrites_the_masks(inputs):
    """`previous_link` acts before the update, so the stage's masks depend on
    the previous kernels; `previous_type` alone feeds only the track branch."""
    x, prop, masks, prev = (t(inputs[k]) for k in ("x", "prop", "masks", "prev"))
    cfg = _cfg(KernelUpdateHeadConfig, KernelUpdatorConfig)
    for link, moves in ((None, False), ("update_dynamic_cov", True)):
        tm = KernelUpdateHead(cfg, with_previous=True, previous_type="update",
                              previous_link=link)
        init_parameters(tm, torch.Generator().manual_seed(0))
        with torch.no_grad():
            a = tm(x, prop, masks, prev)
            b = tm(x, prop, masks, torch.zeros_like(prev))
        assert (not torch.equal(a[1], b[1])) == moves, link
        assert not torch.equal(a[3], b[3])


def test_unknown_and_unported_variants_raise():
    cfg = _cfg(KernelUpdateHeadConfig, KernelUpdatorConfig)
    with pytest.raises(ValueError):
        KernelUpdateHead(cfg, with_previous=True, previous_type="attn")
    with pytest.raises(ValueError):
        KernelUpdateHead(cfg, with_previous=True, previous_link="link_ffn")
    # K=3 builds (tests/test_torch_port_sfnet.py holds it to JAX): the kernel
    # attention runs on the 9 taps flattened
    k3 = KernelUpdateHead(dataclasses.replace(cfg, conv_kernel_size=3))
    assert k3.attention_norm.normalized_shape == (9 * cfg.in_channels,)
