"""The port's SFNet aligned head, DCN and STDC (`models/sfnet.py`,
`models/deform_conv.py`), the K>1 dynamic conv (`assemble_masks`,
`KernelUpdateHead`), and the VIS heads that ignore those options, against
the JAX package on the CPU.

Weights are the port's seeded init with DCN's zero-initialized offset conv
drawn nonzero (`train_check.draw_zero_init_leaves`, offsets of a pixel or
two, fractional, some taps off the map), norms and BN statistics perturbed,
carried to flax by `utils/convert.py` (the tree held against
`jax.eval_shape` of JAX's init). Tolerances, of each output's scale:
- `grid_sample_bilinear` with coordinates outside [-1, 1]: 1e-6, and
  torch's own `F.grid_sample(align_corners=True)` within 1e-5;
- `DeformConv2d`, both aligned modules, `UperNetAlignHead` v1 and v2,
  `STDCNet` (the 813 layout, odd sizes): 1e-5 (fp32 sums in another order);
- `ConvKernelHead(fpn_type='upernet_align')` (K1 / K2 on their plain
  versions here): 1e-4, as the other head tests;
- `assemble_masks` at K=3 (B=2, odd H and W): 1e-5; `KernelUpdateHead` at
  K=3 with and without `with_previous`: 1e-4;
- the R-50 VPS model with `upernet_align` has JAX's tree (38,202,270
  parameters).
The VIS repairs: a volume-mode KNetVIS with `upernet_align` or K=3 gives
outputs bit-equal to the default volume model's (existing tests hold that
one to JAX) and has JAX's tree; frame mode with `upernet_align` raises
JAX's ValueError; VPS, image and frame-mode VIS models at K=3 fail at the
mask assembly's shape check, as JAX's do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import trained_golden_common as jtg
from torch_port_common import (
    assert_rel_close,
    jax_tree_shapes,
    jit_apply,
    seeded_inputs,
    shared_weights,
    t,
)

from video_knet_tpu import config as jconfig
from video_knet_tpu import config_vis as jconfig_vis
from video_knet_tpu.models import deform_conv as jdcn
from video_knet_tpu.models import sfnet as jsfnet
from video_knet_tpu.models.kernel_head import ConvKernelHead as JConvKernelHead
from video_knet_tpu.models.kernel_update_head import KernelUpdateHead as JKernelUpdateHead
from video_knet_tpu.models.kernel_update_head import assemble_masks as jassemble_masks
from video_knet_tpu.models.knet import KNet as JKNet
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu.models.vis.knet_vis import KNetVIS as JKNetVIS
from video_knet_tpu_torch import config as tconfig
from video_knet_tpu_torch import config_vis as tconfig_vis
from video_knet_tpu_torch.models import deform_conv, sfnet
from video_knet_tpu_torch.models.deform_conv import dcn_sample_points
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead
from video_knet_tpu_torch.models.kernel_update_head import KernelUpdateHead, assemble_masks
from video_knet_tpu_torch.models.knet import KNet
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
from video_knet_tpu_torch.tools import trained_golden
from video_knet_tpu_torch.tools.train_check import image_check_cfg, vis_check_cfg
from video_knet_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(1)

FWD_TOL = 1e-5
HEAD_TOL = 1e-4
C = 32


def test_grid_sample_bilinear_matches_jax_and_torch():
    x, gx, gy = seeded_inputs(0, (2, 5, 7, 6), (2, 9, 11), (2, 9, 11))
    gx, gy = gx * 0.8, gy * 0.8  # ~20% of the points fall outside [-1, 1]
    assert (np.abs(gx) > 1).mean() > 0.1 and (np.abs(gy) > 1).mean() > 0.1
    want = jax.jit(jsfnet.grid_sample_bilinear)(x, gx, gy)
    got = sfnet.grid_sample_bilinear(t(x), t(gx), t(gy))
    assert_rel_close(got, want, 1e-6, "grid_sample_bilinear")
    ref = F.grid_sample(t(x).permute(0, 3, 1, 2), torch.stack([t(gx), t(gy)], dim=-1),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    assert_rel_close(got, ref.permute(0, 2, 3, 1), FWD_TOL, "vs F.grid_sample")


def test_deform_conv_matches_jax():
    (x,) = seeded_inputs(1, (2, 9, 13, 8))
    jmod = jdcn.DeformConv2d(features=12)
    port = deform_conv.DeformConv2d(8, 12)
    variables = shared_weights(port, jmod, jnp.asarray(x))
    with torch.no_grad():
        ys, xs = dcn_sample_points(port.offset_conv(t(x)), 3)
        got = port(t(x))
    off_y = ys - torch.arange(9.0)[None, :, None, None]
    assert (off_y.frac() != 0).float().mean() > 0.9  # fractional offsets
    outside = (ys < 0) | (ys > 8) | (xs < 0) | (xs > 12)
    assert 0.05 < outside.float().mean() < 0.5  # some taps off the map
    assert_rel_close(got, jit_apply(jmod, variables, jnp.asarray(x)), FWD_TOL, "DCN")


@pytest.mark.parametrize("v2", [False, True])
def test_aligned_module_matches_jax(v2):
    low, high = seeded_inputs(2, (2, 8, 12, 16), (2, 4, 6, 16))
    jcls = jsfnet.AlignedModuleV2PoolingAtten if v2 else jsfnet.AlignedModule
    pcls = sfnet.AlignedModuleV2PoolingAtten if v2 else sfnet.AlignedModule
    jmod, port = jcls(outplane=8), pcls(16, 16, 8)
    args = (jnp.asarray(low), jnp.asarray(high))
    variables = shared_weights(port, jmod, *args)
    with torch.no_grad():
        got = port(t(low), t(high))
    assert_rel_close(got, jit_apply(jmod, variables, *args), FWD_TOL, f"aligned v2={v2}")


def _levels(seed: int, hw=(64, 96), width=C):
    return seeded_inputs(seed, *[(1, hw[0] // s, hw[1] // s, width) for s in (4, 8, 16, 32)])


@pytest.mark.parametrize("align_type", ["v1", "v2"])
def test_upernet_align_head_matches_jax(align_type):
    feats = _levels(3)
    jfeats = [jnp.asarray(f) for f in feats]
    jmod = jsfnet.UperNetAlignHead(out_channels=C, num_aux_convs=2, align_type=align_type)
    port = sfnet.UperNetAlignHead(C, C, num_aux_convs=2, align_type=align_type)
    variables = shared_weights(port, jmod, jfeats)
    with torch.no_grad():
        got = port([t(f) for f in feats])
    want = jit_apply(jmod, variables, jfeats)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (1, 8, 12, C)  # the stride-8 level's size
        assert_rel_close(g, w, FWD_TOL, f"{align_type} output {i}")


def test_stdcnet813_matches_jax():
    (x,) = seeded_inputs(4, (1, 56, 88, 3))  # stride 4..32: 14x22, 7x11, 4x6, 2x3
    jmod = jsfnet.STDCNet(layers=(2, 2, 2))
    port = sfnet.STDCNet(layers=(2, 2, 2))
    variables = shared_weights(port, jmod, jnp.asarray(x))
    with torch.no_grad():
        got = port(t(x))
    want = jit_apply(jmod, variables, jnp.asarray(x))
    assert [g.shape[-1] for g in got] == list(port.out_channels) == [64, 256, 512, 1024]
    for s, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g, w, FWD_TOL, f"STDC level {s}")


def test_conv_kernel_head_upernet_align_matches_jax():
    kw = dict(num_proposals=20, in_channels=C, out_channels=C, fpn_feat_channels=C,
              fpn_type="upernet_align", fpn_num_aux_convs=0)
    feats = _levels(5)
    jfeats = [jnp.asarray(f) for f in feats]
    jmod = JConvKernelHead(jconfig.ConvKernelHeadConfig(**kw))
    port = ConvKernelHead(tconfig.ConvKernelHeadConfig(**kw), in_channels=C)
    assert port.localization_fpn.num_aux_convs == 1  # max(fpn_num_aux_convs, 1)
    variables = shared_weights(port, jmod, jfeats)
    with torch.no_grad():
        got = port([t(f) for f in feats])
    want = jit_apply(jmod, variables, jfeats)
    for name in got._fields:
        assert_rel_close(getattr(got, name), getattr(want, name), HEAD_TOL, name)


def test_assemble_masks_k3_matches_jax():
    kernels, x = seeded_inputs(6, (2, 5, 9, C), (2, 9, 13, C))
    want = jax.jit(jassemble_masks, static_argnums=2)(kernels, x, 3)
    got = assemble_masks(t(kernels), t(x), 3)
    assert got.shape == (2, 5, 9, 13)
    assert_rel_close(got, want, FWD_TOL, "assemble_masks K=3")
    with pytest.raises(ValueError, match=r"\(2, 5, 1, 32\)"):
        assemble_masks(t(kernels[:, :, :1]), t(x), 3)


def _head_cfgs(k: int):
    kw = dict(in_channels=C, out_channels=C, feedforward_channels=64, num_heads=8,
              mask_upsample_stride=4, conv_kernel_size=k)
    return (jconfig.KernelUpdateHeadConfig(updator=jconfig.KernelUpdatorConfig(C, C, C), **kw),
            tconfig.KernelUpdateHeadConfig(updator=tconfig.KernelUpdatorConfig(C, C, C), **kw))


@pytest.mark.parametrize("with_previous", [False, True])
def test_kernel_update_head_k3_matches_jax(with_previous):
    jcfg, cfg = _head_cfgs(3)
    x, prop, masks, prev = seeded_inputs(7, (2, 9, 13, C), (2, 6, 9, C), (2, 6, 9, 13),
                                         (2, 6, 9, C))
    masks = masks * 3
    args = (x, prop, masks, prev if with_previous else None)
    jmod = JKernelUpdateHead(jcfg, with_previous=with_previous)
    port = KernelUpdateHead(cfg, with_previous=with_previous)
    variables = shared_weights(port, jmod, *args)
    assert port.attention.query.weight.shape == (9 * C, 9 * C)
    with torch.no_grad():
        got = port(*[None if a is None else t(a) for a in args])
        with pytest.raises(ValueError, match="cannot reshape"):
            port(t(x), t(prop[:, :, :1]), t(masks))  # one tap at K=3, as JAX's fails
    want = jit_apply(jmod, variables, *args)
    for name, g, w in zip(("cls_score", "mask_preds", "obj_feat", "obj_feat_track"), got, want):
        if w is None:
            assert g is None
        else:
            assert_rel_close(g, w, HEAD_TOL, name)


def test_upernet_align_vps_parameter_tree_is_jax(monkeypatch):
    """Only the tree is read: the port's random init is skipped."""
    monkeypatch.setattr("video_knet_tpu_torch.models.video.knet_vps.init_parameters",
                        lambda *a: None)
    change = dict(fpn_type="upernet_align")
    cfg = tconfig.VideoKNetConfig()
    cfg = dataclasses.replace(cfg, rpn=dataclasses.replace(cfg.rpn, **change))
    jcfg = jconfig.VideoKNetConfig()
    jcfg = dataclasses.replace(jcfg, rpn=dataclasses.replace(jcfg.rpn, **change))
    model = VideoKNet(cfg, device="cpu")
    assert isinstance(model.rpn_head.localization_fpn, sfnet.UperNetAlignHead)
    flat = state_dict_to_flax(model, model.state_dict())
    x = jnp.zeros((1, 64, 96, 3))
    assert {k: v.shape for k, v in flat.items()} == jax_tree_shapes(JVideoKNet(jcfg), x, x)
    assert sum(int(np.prod(v.shape)) for k, v in flat.items()
               if k.startswith("params/")) == 38_202_270


# ------------------------------------------------------------- the VIS repairs

T, HW = 2, (64, 96)


def _vis_cfgs(**change):
    def make(base, rpn_cls, head_cls):
        cfg = vis_check_cfg(base)
        rpn = {k: v for k, v in change.items() if k in rpn_cls.__dataclass_fields__}
        head = {k: v for k, v in change.items() if k in head_cls.__dataclass_fields__}
        top = {k: v for k, v in change.items() if k not in rpn and k not in head}
        return dataclasses.replace(cfg, rpn=dataclasses.replace(cfg.rpn, **rpn),
                                   head=dataclasses.replace(cfg.head, **head), **top)

    return (make(jconfig_vis.VISConfig(), jconfig.ConvKernelHeadConfig,
                 jconfig.KernelUpdateHeadConfig),
            make(tconfig_vis.VISConfig(), tconfig.ConvKernelHeadConfig,
                 tconfig.KernelUpdateHeadConfig))


@pytest.fixture(scope="module")
def volume_default():
    _, cfg = _vis_cfgs(kernel_head_mode="volume")
    model = KNetVIS(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    (clip,) = seeded_inputs(8, (1, T, *HW, 3))
    with torch.no_grad():
        return model, model(t(clip)), clip


@pytest.mark.parametrize("change", [dict(fpn_type="upernet_align"), dict(conv_kernel_size=3)])
def test_volume_vis_ignores_the_option_as_jax_does(change, volume_default):
    base_model, base_out, clip = volume_default
    jcfg, cfg = _vis_cfgs(kernel_head_mode="volume", **change)
    model = KNetVIS(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    flat = state_dict_to_flax(model, model.state_dict())
    assert {k: v.shape for k, v in flat.items()} == jax_tree_shapes(
        JKNetVIS(jcfg), jnp.zeros((1, T, *HW, 3)))
    with torch.no_grad():
        out = model(t(clip))
    got, want = jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(base_out)
    assert len(got) == len(want) > 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_frame_vis_with_upernet_align_raises_as_jax_does():
    jcfg, cfg = _vis_cfgs(fpn_type="upernet_align")
    msg = "has no 3-D temporal positional encoding"
    with pytest.raises(ValueError, match=msg):
        jax_tree_shapes(JKNetVIS(jcfg), jnp.zeros((1, T, *HW, 3)))
    model = KNetVIS(cfg, device="cpu")
    with pytest.raises(ValueError, match=msg), torch.no_grad():
        model(torch.zeros(1, T, *HW, 3))


def _k3(cfg):
    return dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, conv_kernel_size=3))


@pytest.mark.parametrize("kind", ["vps", "image", "vis_frame"])
def test_models_at_k3_fail_as_jax_does(kind):
    """The init head gives one tap a kernel, which neither package can
    reshape to K*K = 9 at the first stage's mask assembly."""
    x = jnp.zeros((1, *HW, 3))
    if kind == "vps":
        jcfg, cfg = _k3(jtg.tiny_cfg()), _k3(trained_golden.tiny_cfg())
        jmod, jargs = JVideoKNet(jcfg), (x, x)
        model = VideoKNet(cfg, device="cpu")
        run = lambda: model.run_branch(torch.zeros(1, *HW, 3))  # noqa: E731
    elif kind == "image":
        jcfg = _k3(image_check_cfg(jconfig.KNetConfig(), deformable=False))
        cfg = _k3(image_check_cfg(tconfig.KNetConfig(), deformable=False))
        jmod, jargs = JKNet(jcfg), (x,)
        model = KNet(cfg, device="cpu")
        run = lambda: model(torch.zeros(1, *HW, 3))  # noqa: E731
    else:
        jcfg, cfg = _vis_cfgs(conv_kernel_size=3)
        jmod, jargs = JKNetVIS(jcfg), (jnp.zeros((1, T, *HW, 3)),)
        model = KNetVIS(cfg, device="cpu")
        run = lambda: model(torch.zeros(1, T, *HW, 3))  # noqa: E731
    with pytest.raises(TypeError, match=r"cannot reshape array of shape \(\d+, \d+, 1, \d+\)"):
        jax_tree_shapes(jmod, *jargs)
    with pytest.raises(ValueError, match=r"cannot reshape kernels of shape \(\d+, \d+, 1, \d+\)"):
        with torch.no_grad():
            run()
