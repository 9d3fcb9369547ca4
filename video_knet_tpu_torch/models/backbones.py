"""Backbone + neck factory: ResNet-50/101, MiT (b0-b5) and Swin
(tiny/small/base/large), each with the FPN or the MSDeformAttn pixel
decoder."""

from __future__ import annotations

from torch import nn

from video_knet_tpu_torch.models.mit import MixVisionTransformer
from video_knet_tpu_torch.models.msdeform_decoder import MSDeformAttnPixelDecoder
from video_knet_tpu_torch.models.resnet import FPN, RESNET_STAGE_BLOCKS, ResNet
from video_knet_tpu_torch.models.swin import SWIN_PRESETS, SwinTransformer


def build_backbone(name: str, frozen_stages: int = -1, drop_path_rate: float = 0.0) -> nn.Module:
    """The backbone module; its four stage widths are `out_channels`.
    `frozen_stages` applies to ResNet and Swin (MiT ignores it, as in the
    reference); `drop_path_rate` is Swin's stochastic depth."""
    depths = {f"resnet{d}": d for d in RESNET_STAGE_BLOCKS}
    if name in depths:
        return ResNet(depth=depths[name], frozen_stages=frozen_stages)
    if name.startswith("mit_"):
        return MixVisionTransformer(preset=name.split("_", 1)[1])
    if name.startswith("swin_") and name[len("swin_"):] in SWIN_PRESETS:
        return SwinTransformer(preset=name[len("swin_"):], frozen_stages=frozen_stages,
                               drop_path_rate=drop_path_rate)
    raise NotImplementedError(
        f"backbone {name!r} is not ported yet (ROADMAP E1: RFP / DetectoRS)")


def build_neck(neck_type: str, backbone: nn.Module) -> nn.Module:
    """The neck over `backbone`'s stage outputs (flax's FPN infers its input
    widths; the port reads them from the backbone)."""
    if neck_type == "fpn":
        return FPN(in_channels=backbone.out_channels)
    if neck_type == "msdeform_pixel_decoder":
        return MSDeformAttnPixelDecoder(in_channels=backbone.out_channels)
    raise ValueError(f"unknown neck_type {neck_type!r}")
