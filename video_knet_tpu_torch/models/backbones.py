"""Backbone + neck factory: ResNet-50 and MiT (b0-b5), each with the FPN."""

from __future__ import annotations

from torch import nn

from video_knet_tpu_torch.models.mit import MixVisionTransformer
from video_knet_tpu_torch.models.resnet import FPN, ResNet


def build_backbone(name: str, frozen_stages: int = -1) -> nn.Module:
    """The backbone module; its four stage widths are `out_channels`.
    `frozen_stages` applies to ResNet (MiT ignores it, as in the reference)."""
    if name == "resnet50":
        return ResNet(depth=50, frozen_stages=frozen_stages)
    if name.startswith("mit_"):
        return MixVisionTransformer(preset=name.split("_", 1)[1])
    raise NotImplementedError(
        f"backbone {name!r} is not ported yet (slices C/E of the ROADMAP)"
    )


def build_neck(neck_type: str, backbone: nn.Module) -> nn.Module:
    """The neck over `backbone`'s stage outputs (flax's FPN infers its input
    widths; the port reads them from the backbone)."""
    if neck_type == "fpn":
        return FPN(in_channels=backbone.out_channels)
    raise NotImplementedError(f"neck {neck_type!r} is not ported yet (ROADMAP E2)")
