"""Backbone + neck factory. This slice ports ResNet-50 + FPN only."""

from __future__ import annotations

from torch import nn

from video_knet_tpu_torch.models.resnet import FPN, ResNet


def build_backbone(name: str) -> nn.Module:
    if name == "resnet50":
        return ResNet(depth=50)
    raise NotImplementedError(
        f"backbone {name!r} is not ported yet (ROADMAP A8 for MiT-b0, slices C/E "
        "for the others)"
    )


def build_neck(neck_type: str, backbone: str) -> nn.Module:
    if neck_type == "fpn" and backbone == "resnet50":
        return FPN()
    raise NotImplementedError(
        f"neck {neck_type!r} on backbone {backbone!r} is not ported yet (ROADMAP E2)"
    )
