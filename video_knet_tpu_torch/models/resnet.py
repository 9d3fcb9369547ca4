"""ResNet backbone (torch-style bottleneck) and mmdet-style FPN, NHWC.

Counterpart of `video_knet_tpu/models/resnet.py`. BatchNorm follows the
reference's `ura_for`: it normalizes with its running averages when the
model is in eval mode (flax's `train=False`: serving, the eval hook), with
`norm_eval=True` (the release configs; its affine parameters still train),
and in the stem and stages 1..`frozen_stages` always; otherwise, in
training mode (`model.train()`, which the train steps set), it runs on the
batch statistics and updates its running averages (`layers.py:
BatchNorm`). `frozen_stages=k` freezes the stem and stages 1..k as the
reference does: their parameters take no gradient, and the activations
leaving them are detached (the reference's `stop_gradient`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import BatchNorm, Conv2d, max_pool_3x3_s2, resize_nearest

RESNET_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 use_running_average: bool = True):
        super().__init__()
        ura = use_running_average
        self.conv1 = Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = BatchNorm(features, use_running_average=ura)
        self.conv2 = Conv2d(features, features, 3, stride=stride, bias=False)
        self.bn2 = BatchNorm(features, use_running_average=ura)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = BatchNorm(features * 4, use_running_average=ura)
        self.has_downsample = in_ch != features * 4 or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, features * 4, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(features * 4, use_running_average=ura)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Returns the four stage outputs (strides 4, 8, 16, 32), NHWC; their
    widths are `out_channels`. The stem is stage 0 of `ura_for`."""

    def __init__(self, depth: int = 50, frozen_stages: int = -1, norm_eval: bool = True):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        widths = (64, 128, 256, 512)
        self.out_channels = tuple(w * 4 for w in widths)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, use_running_average=self.ura_for(0))
        self.stage_blocks = RESNET_STAGE_BLOCKS[depth]
        in_ch = 64
        for s, (w, n_blocks) in enumerate(zip(widths, self.stage_blocks), start=1):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 1) else 1
                self.add_module(f"layer{s}_block{b}",
                                BottleneckBlock(in_ch, w, stride, self.ura_for(s)))
                in_ch = w * 4
        frozen = ([self.conv1, self.bn1] if frozen_stages >= 0 else []) + [
            getattr(self, f"layer{s}_block{b}") for s in range(1, frozen_stages + 1)
            for b in range(self.stage_blocks[s - 1])]
        for m in frozen:
            m.requires_grad_(False)

    def ura_for(self, stage_idx: int) -> bool:
        """Whether stage `stage_idx`'s BatchNorms keep their running averages
        in training mode (in eval mode they always do)."""
        return self.norm_eval or stage_idx <= self.frozen_stages

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """`generator` is ignored: ResNet has no stochastic depth."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = max_pool_3x3_s2(y)
        if self.frozen_stages >= 0:
            y = y.detach()
        outs = []
        for s, n_blocks in enumerate(self.stage_blocks, start=1):
            for b in range(n_blocks):
                y = getattr(self, f"layer{s}_block{b}")(y)
            if self.frozen_stages >= s:
                y = y.detach()
            outs.append(y)
        return outs


class FPN(nn.Module):
    """Lateral 1x1 + nearest top-down sum + 3x3 output convs; 4 levels."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256,
                 num_outs: int = 4):
        super().__init__()
        self.out_channels = out_channels
        self.num_outs = num_outs
        self.num_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_conv{i}", Conv2d(out_channels, out_channels, 3))

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.num_levels - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i], (h, w), dims=(1, 2))
        outs = [getattr(self, f"fpn_conv{i}")(l) for i, l in enumerate(laterals)]
        return outs[: self.num_outs]
