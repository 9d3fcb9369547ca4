"""The port's config presets (`config.py`, `configs.py`) against the JAX package.

Every preset name of `video_knet_tpu/configs.py` is in the port's registry.
Each VPS, image and VIS preset equals JAX's field by field (dataclasses
only: no Swin-B/L VPS model is built here); the deformable VIS presets
build KNetVIS with the MSDeformAttn neck on the CPU. Each image preset builds
`models/knet.py:KNet` on the CPU (Swin-B/L included), where `VideoKNet`
raises and names it; the RFP / DetectoRS image presets raise, naming
ROADMAP E1, and the two other track heads raise, naming E3. Also the
dataset configs and `build_backbone`'s names.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from video_knet_tpu import config as jc
from video_knet_tpu import configs as jconfigs
from video_knet_tpu.config_vis import VISConfig
from video_knet_tpu.models.video.knet_vps import QueryTrackEmbed as JQueryTrackEmbed
from video_knet_tpu.models.video.roi_track_head import ROITrackHead as JROITrackHead
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch import config_vis as tc_vis
from video_knet_tpu_torch import configs as tconfigs
from video_knet_tpu_torch.models.backbones import build_backbone
from video_knet_tpu_torch.models.rfp import RFP
from video_knet_tpu_torch.models.knet import KNet
from video_knet_tpu_torch.models.msdeform_decoder import MSDeformAttnPixelDecoder
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
from video_knet_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(1)  # one intra-op thread a worker, as tests/torch_port_common.py

VIS = sorted(k for k, f in jconfigs.CONFIGS.items() if isinstance(f(), VISConfig))
NON_VIS = sorted(set(jconfigs.CONFIGS) - set(VIS))
# the presets VideoKNet does not build: the image ones (KNet builds them)
UNPORTED = sorted(k for k in NON_VIS if not isinstance(jconfigs.get_config(k),
                                                       jc.VideoKNetConfig))
TRACK_HEAD_PRESETS = {"video_knet_kitti_step_fuse_track": "query_fuse",
                      "video_knet_kitti_step_roi_gt_box": "roi_gt_box"}


def test_registry_has_every_name():
    assert set(tconfigs.CONFIGS) == set(jconfigs.CONFIGS)
    assert set(tconfigs.VIS_CONFIGS) == set(VIS)


@pytest.mark.parametrize("name", NON_VIS)
def test_preset_equals_jax(name):
    got, want = tconfigs.get_config(name), jconfigs.get_config(name)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("factory", ["kitti_step_image_config", "kitti_step_video_config",
                                     "semkitti_video_config", "vipseg_video_config"])
def test_dataset_config_equals_jax(factory):
    assert dataclasses.asdict(getattr(tc, factory)()) == dataclasses.asdict(
        getattr(jc, factory)())


def test_vipseg_class_split():
    cfg = tconfigs.get_config("video_knet_vipseg_swin_b")
    assert (cfg.num_thing_classes, cfg.num_stuff_classes, cfg.num_classes) == (58, 66, 124)
    assert cfg.num_proposals + cfg.num_stuff_classes == 166
    assert (cfg.backbone, cfg.backbone_drop_path_rate, cfg.previous_type) == (
        "swin_base", 0.3, "ffn")


@pytest.mark.parametrize("name", VIS)
def test_vis_preset_equals_jax_or_raises_naming_e2(name):
    """Every VIS preset equals JAX's field by field, the four deformable
    ones (once ROADMAP E2's raise) included."""
    want = jconfigs.get_config(name)
    got = tconfigs.get_config(name)
    assert isinstance(got, tc_vis.VISConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_thing_classes, got.num_stuff_classes) == (40, 0)
    assert (name in tconfigs.DEFORMABLE_VIS_CONFIGS) == (
        got.neck_type == "msdeform_pixel_decoder")


@pytest.mark.parametrize("name", ["video_knet_vis_r50_deformable_ytvis2019",
                                  "video_knet_vis_swin_b_deformable_ytvis2019"])
def test_deformable_vis_preset_builds_the_msdeform_neck(name):
    """The two deformable VIS configs (the other two names are aliases of
    them) build KNetVIS on the CPU with the 6-layer MSDeformAttn decoder
    over the backbone's four levels."""
    model = KNetVIS(tconfigs.get_config(name), device="cpu")
    assert isinstance(model.neck, MSDeformAttnPixelDecoder)
    assert model.neck.num_layers == 6
    assert model.neck.input_proj0.weight.shape[1] == model.backbone.out_channels[1]


def test_unknown_config_raises():
    with pytest.raises(KeyError):
        tconfigs.get_config("no_such_config")


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_preset_raises_at_model_construction(name):
    """VideoKNet raises for each; an image preset builds KNet on the CPU
    instead, with the neck its config names, or none over the RFP /
    DetectoRS backbones, whose output is the pyramid
    (`tests/test_torch_port_rfp.py` holds their trees to JAX's)."""
    cfg = tconfigs.get_config(name)
    with pytest.raises(NotImplementedError, match="models.knet.KNet"):
        VideoKNet(cfg, device="cpu")
    model = KNet(cfg, device="cpu")
    if cfg.backbone in ("detectors_r50", "swin_b_rfp"):
        assert model.neck is None and isinstance(model.backbone, RFP)
    else:
        deformable = cfg.neck_type == "msdeform_pixel_decoder"
        assert isinstance(model.neck, MSDeformAttnPixelDecoder) == deformable
    assert model.rpn_head.conv_seg.weight.shape[0] == cfg.num_classes
    assert model.roi_head.num_stages == cfg.num_stages == 3


@pytest.mark.parametrize("name", sorted(TRACK_HEAD_PRESETS))
def test_track_head_preset_builds_with_jax_shapes(name):
    """The fuse-track and RoI GT-box presets build on the CPU; every leaf of
    the track head has the shape of JAX's init of the same head."""
    cfg = tconfigs.get_config(name)
    assert cfg.track_head_type == TRACK_HEAD_PRESETS[name]
    model = VideoKNet(cfg, device="cpu")
    if cfg.track_head_type == "query_fuse":
        prefix = "params/track_embed/"
        jhead = JQueryTrackEmbed(cfg.track.in_channels, cfg.track.query_fc_out_channels)
        args = (jnp.zeros((1, cfg.num_proposals, cfg.head.in_channels)),)
    else:
        prefix = "params/roi_track_head/"
        jhead = JROITrackHead(cfg.track.embed_channels)
        args = (jnp.zeros((1, 48, 156, cfg.rpn.out_channels)),
                jnp.zeros((1, cfg.max_insts, 4)), 0.5)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), *args)["params"]
    want = {f"{prefix}{'/'.join(k.key for k in path)}": tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(v.shape) for k, v in state_dict_to_flax(model, model.state_dict()).items()
           if k.startswith(prefix)}
    assert got == want and len(want) == (4 if cfg.track_head_type == "query_fuse" else 20)


def test_build_backbone_names():
    r101 = build_backbone("resnet101")
    assert r101.out_channels == (256, 512, 1024, 2048)
    assert sum(1 for n, _ in r101.named_children() if n.startswith("layer3_")) == 23
    assert build_backbone("swin_tiny").out_channels == (96, 192, 384, 768)
    for name, inner in (("swin_b_rfp", "base"), ("detectors_r50", None),
                        ("swin_t_rfp", "tiny"), ("detectors_r101", None)):
        rfp = build_backbone(name)
        assert isinstance(rfp, RFP) and rfp.out_channels == (256,) * 4
        if inner is None:
            assert sum(1 for n, _ in rfp.bb.named_children() if n.startswith("layer3_")) == (
                23 if name.endswith("101") else 6)
        else:
            assert rfp.bb.out_channels[0] == {"base": 128, "tiny": 96}[inner]
    for name in ("resnet18", "swin_huge"):
        with pytest.raises(ValueError, match="unknown backbone"):
            build_backbone(name)
