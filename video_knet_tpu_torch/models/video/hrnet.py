"""HRNet appearance encoder of UniTrack's zoo (hrnet_w18 / hrnet_w32).

Counterpart of `video_knet_tpu/models/video/hrnet.py` (the reference's
HighResolutionNet): a stride-4 stem, four stages of parallel branches at
strides 4 / 8 / 16 / 32 with full cross-resolution fusion after every
module, then the classification head's Bottleneck + stride-2 downsample
chain; the forward returns the head's `return_stage` accumulator resized
to the stride-8 map. NHWC throughout, BatchNorm on running statistics.

XLA's arithmetic where torch's defaults differ: the 3x3 convs pad (1, 1)
explicitly (as the reference does); the fuse layers' nearest upsample is
an exact repeat (integer factors), then a centre crop to the target map;
the last resize is `jax.image.resize(..., "linear")`
(`layers.resize_bilinear`: no antialias when it upsamples, as for
return_stage 2 and 3; antialiased when it shrinks). Submodules carry
flax's names, so `utils/convert.py` maps the reference's variables
unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import BatchNorm, Conv2d, resize_bilinear
from video_knet_tpu_torch.models.resnet import BottleneckBlock
from video_knet_tpu_torch.models.video.appearance import BasicBlock

# (num_modules, num_blocks) of stages 2..4; branch widths are width * 2^i
HRNET_STAGES = ((1, 4), (4, 4), (3, 4))
HRNET_HEAD_CHANNELS = (32, 64, 128, 256)  # Bottleneck planes (out = 4x)


def _nearest_up(x: torch.Tensor, factor: int) -> torch.Tensor:
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


class HRNetEncoder(nn.Module):
    """HighResolutionNet, frozen, one NHWC output: the head accumulator
    `return_stage` (0..3) resized to the stride-8 map."""

    def __init__(self, width: int = 18, return_stage: int = 2):
        super().__init__()
        self.return_stage = return_stage
        w = width
        widths = (w, 2 * w, 4 * w, 8 * w)
        self.widths = widths

        def conv3(name, cin, cout, stride, bias=False):
            self.add_module(name, Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias))

        def bn(name, c):
            self.add_module(name, BatchNorm(c))

        conv3("conv1", 3, 64, 2)
        bn("bn1", 64)
        conv3("conv2", 64, 64, 2)
        bn("bn2", 64)
        for b in range(4):
            self.add_module(f"layer1_block{b}", BottleneckBlock(64 if b == 0 else 256, 64, 1))
        conv3("transition1_0_conv", 256, widths[0], 1)
        bn("transition1_0_bn", widths[0])
        conv3("transition1_1_0_conv", 256, widths[1], 2)
        bn("transition1_1_0_bn", widths[1])
        for s, (num_modules, num_blocks) in enumerate(HRNET_STAGES, start=2):
            if s > 2:
                conv3(f"transition{s - 1}_{s - 1}_0_conv", widths[s - 2], widths[s - 1], 2)
                bn(f"transition{s - 1}_{s - 1}_0_bn", widths[s - 1])
            for m in range(num_modules):
                for b in range(s):
                    for k in range(num_blocks):
                        self.add_module(f"stage{s}_m{m}_b{b}_block{k}",
                                        BasicBlock(widths[b], widths[b]))
                for i in range(s):
                    for j in range(s):
                        p = f"stage{s}_m{m}_fuse{i}_{j}"
                        if j > i:
                            self.add_module(f"{p}_conv", Conv2d(widths[j], widths[i], 1,
                                                                bias=False))
                            bn(f"{p}_bn", widths[i])
                        elif j < i:
                            for k in range(i - j):
                                cout = widths[i] if k == i - j - 1 else widths[j]
                                conv3(f"{p}_{k}_conv", widths[j], cout, 2)
                                bn(f"{p}_{k}_bn", cout)
        for i in range(4):
            self.add_module(f"incre{i}_block0",
                            BottleneckBlock(widths[i], HRNET_HEAD_CHANNELS[i], 1))
        for i in range(3):
            conv3(f"downsamp{i}_conv", HRNET_HEAD_CHANNELS[i] * 4,
                  HRNET_HEAD_CHANNELS[i + 1] * 4, 2, bias=True)
            bn(f"downsamp{i}_bn", HRNET_HEAD_CHANNELS[i + 1] * 4)
        self.out_channels = HRNET_HEAD_CHANNELS[return_stage] * 4

    def _cbr(self, name: str, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        y = getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))
        return F.relu(y) if relu else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        for b in range(4):
            y = getattr(self, f"layer1_block{b}")(y)
        xs = [self._cbr("transition1_0", y), self._cbr("transition1_1_0", y)]
        for s, (num_modules, num_blocks) in enumerate(HRNET_STAGES, start=2):
            if s > 2:
                xs.append(self._cbr(f"transition{s - 1}_{s - 1}_0", xs[-1]))
            for m in range(num_modules):
                for b in range(s):
                    for k in range(num_blocks):
                        xs[b] = getattr(self, f"stage{s}_m{m}_b{b}_block{k}")(xs[b])
                fused = []
                for i in range(s):
                    acc = None
                    for j in range(s):
                        p = f"stage{s}_m{m}_fuse{i}_{j}"
                        if j == i:
                            t = xs[j]
                        elif j > i:
                            t = _nearest_up(self._cbr(p, xs[j], relu=False), 2 ** (j - i))
                            th, tw = xs[i].shape[1], xs[i].shape[2]
                            oh, ow = (t.shape[1] - th) // 2, (t.shape[2] - tw) // 2
                            t = t[:, oh:oh + th, ow:ow + tw, :]
                        else:
                            t = xs[j]
                            for k in range(i - j):
                                t = self._cbr(f"{p}_{k}", t, relu=k != i - j - 1)
                        acc = t if acc is None else acc + t
                    fused.append(F.relu(acc))
                xs = fused
        acc = getattr(self, "incre0_block0")(xs[0])
        outs = [acc]
        for i in range(3):
            d = self._cbr(f"downsamp{i}", acc)
            acc = getattr(self, f"incre{i + 1}_block0")(xs[i + 1]) + d
            outs.append(acc)
        return resize_bilinear(outs[self.return_stage], tuple(outs[1].shape[1:3]))
