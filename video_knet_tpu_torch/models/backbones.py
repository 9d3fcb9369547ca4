"""Backbone + neck factory: ResNet-50/101, MiT (b0-b5), Swin
(tiny/small/base/large), each with the FPN or the MSDeformAttn pixel
decoder, and the DetectoRS / RFP recursive backbones, whose output is
already the 4-level 256-wide pyramid (no neck)."""

from __future__ import annotations

from torch import nn

from video_knet_tpu_torch.models.mit import MixVisionTransformer
from video_knet_tpu_torch.models.msdeform_decoder import MSDeformAttnPixelDecoder
from video_knet_tpu_torch.models.resnet import FPN, RESNET_STAGE_BLOCKS, ResNet
from video_knet_tpu_torch.models.rfp import RFP, rfp_backbone_name
from video_knet_tpu_torch.models.swin import SWIN_PRESETS, SwinTransformer
from video_knet_tpu_torch.parallel.mesh import share_rows
from video_knet_tpu_torch.parallel.model_axis import (
    active_split,
    frame_rows,
    frame_share,
    hold_share,
    image_band,
    running_share,
)

# backbones whose output is already the pyramid (the recursive feature
# pyramid is their neck): models skip the separate neck for these
PYRAMID_BACKBONES = ("detectors_r50", "detectors_r101", "swin_b_rfp",
                     "swin_base_rfp", "swin_t_rfp", "swin_tiny_rfp")


def backbone_is_pyramid(name: str) -> bool:
    return name in PYRAMID_BACKBONES


def build_backbone(name: str, frozen_stages: int = -1, drop_path_rate: float = 0.0,
                   norm_eval: bool = True) -> nn.Module:
    """The backbone module; its four stage widths are `out_channels`.
    `frozen_stages` applies to ResNet and Swin (MiT ignores it, as in the
    reference); `drop_path_rate` is Swin's stochastic depth; `norm_eval`
    is ResNet's (False: live BatchNorm in training mode). The RFP
    backbones ignore all three, as the reference's do. The reference's
    `train` flag is the module's training mode."""
    if backbone_is_pyramid(name):
        return RFP(backbone=rfp_backbone_name(name))
    depths = {f"resnet{d}": d for d in RESNET_STAGE_BLOCKS}
    if name in depths:
        return ResNet(depth=depths[name], frozen_stages=frozen_stages, norm_eval=norm_eval)
    if name.startswith("mit_"):
        return MixVisionTransformer(preset=name.split("_", 1)[1])
    if name.startswith("swin_") and name[len("swin_"):] in SWIN_PRESETS:
        return SwinTransformer(preset=name[len("swin_"):], frozen_stages=frozen_stages,
                               drop_path_rate=drop_path_rate)
    raise ValueError(f"unknown backbone {name!r}")


def build_neck(neck_type: str, backbone: nn.Module) -> nn.Module | None:
    """The neck over `backbone`'s stage outputs (flax's FPN infers its input
    widths; the port reads them from the backbone), or None when the
    backbone's output is already the pyramid (RFP)."""
    if isinstance(backbone, RFP):
        return None
    if neck_type == "fpn":
        return FPN(in_channels=backbone.out_channels)
    if neck_type == "msdeform_pixel_decoder":
        return MSDeformAttnPixelDecoder(in_channels=backbone.out_channels)
    raise ValueError(f"unknown neck_type {neck_type!r}")


def pyramid_width(backbone: nn.Module, neck: nn.Module | None) -> int:
    """The width of the levels the heads take: the neck's, or the RFP's."""
    return backbone.out_channels[0] if neck is None else neck.out_channels


def _pyramid(backbone: nn.Module, neck: nn.Module | None, img, generator):
    feats = backbone(img, generator)
    return feats if neck is None else neck(feats)


def backbone_and_neck(backbone: nn.Module, neck: nn.Module | None, img, generator=None,
                      frames: int | None = None):
    """The pyramid of `img`: the backbone's stage outputs through the neck,
    if there is one. `frames`: `img` holds clips of that many frames, in
    b*T + t order.

    Under a split of the mesh's `model` axis (`parallel/model_axis.py`)
    the backbone and the neck run on this rank's share of `img` and return
    it, gathered nowhere; the share stays active for the heads and the
    losses. The frame split returns this rank's frames of each clip, rows
    `model_axis.frame_rows` of `img` (`model_axis.in_frames`). The band
    split takes every height at which JAX's whole VPS step runs, the
    multiples of 8 rows, with at least as many stride-32 rows (the last one
    partial) as bands: every band but the last ends on a whole stride-32
    row, the last holds the rest (376 rows over 2: 192 + 184). It runs
    every backbone and neck `build_backbone` and `build_neck` make: ResNet,
    Swin and MiT with the FPN or the MSDeformAttn pixel decoder, and the
    RFP backbones (DetectoRS and the RFP Swin), which have no neck. It
    returns this rank's band of each level
    (`model_axis.in_band`), its rows of the whole level at any height
    (`model_axis.level_bands`); a consumer that needs the whole map gathers
    it (`model_axis.whole_map`). ValueError for a height it does not take.
    """
    split = active_split()
    if split is None:
        return _pyramid(backbone, neck, img, generator)
    if split.kind == "rows":
        band, select = image_band(split, img.shape[1], img.shape[2])
        with running_share(band, select):
            share = _pyramid(backbone, neck, select(img), generator)
        hold_share(band, select)
        return share
    if frames is None:
        raise ValueError("the frame split needs the clip length (`frames`)")
    clips = img.shape[0] // frames
    mine = frame_share(split, frames)
    rows = frame_rows(clips, frames, split)

    def select(t):
        return t[rows.to(t.device)]

    with running_share(mine, select), share_rows(img.shape[0], rows):
        share = _pyramid(backbone, neck, select(img), generator)
    hold_share(mine, select)
    return share
