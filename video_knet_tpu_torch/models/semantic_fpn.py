"""Semantic-FPN localization neck (2-D only), NHWC.

Counterpart of `video_knet_tpu/models/semantic_fpn.py`: all four FPN levels
are convolved (+ upsampled) to the level-0/2 resolution and summed; two 1x1
heads give the 'thing' and 'stuff' branch features.
"""

from __future__ import annotations

import torch
from torch import nn

from video_knet_tpu_torch.models.layers import (
    ConvNormAct,
    resize_bilinear,
    sine_positional_encoding,
    upsample2x,
)


class SemanticFPN(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 out_channels: int = 256, upsample_times: int = 2, end_level: int = 3,
                 with_positional_encoding: bool = True, num_aux_convs: int = 1,
                 num_frames: int | None = None):
        super().__init__()
        if num_frames is not None:
            raise NotImplementedError(
                "SemanticFPN num_frames (the 3-D clip variant) is not ported yet "
                "(ROADMAP D1)"
            )
        self.upsample_times = upsample_times
        self.end_level = end_level
        self.with_positional_encoding = with_positional_encoding
        self.num_aux_convs = num_aux_convs
        for j in range(end_level - upsample_times):
            self.add_module(f"l0_conv{j}", ConvNormAct(
                in_channels if j == 0 else feat_channels, feat_channels, 3, stride=2))
        for i in range(1, end_level + 1):
            for j in range(i):
                self.add_module(f"l{i}_conv{j}", ConvNormAct(
                    in_channels if j == 0 else feat_channels, feat_channels, 3))
        self.conv_pred = ConvNormAct(feat_channels, out_channels, 1)
        for k in range(num_aux_convs):
            self.add_module(f"aux_conv{k}", ConvNormAct(feat_channels, out_channels, 1))

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        mlvl = []
        for i in range(self.end_level + 1):
            x = feats[i]
            if i == self.end_level and self.with_positional_encoding:
                h, w, c = x.shape[1:]
                x = x + sine_positional_encoding(h, w, c // 2, device=x.device)[None]
            if i == 0:
                for j in range(self.end_level - self.upsample_times):
                    x = getattr(self, f"l0_conv{j}")(x)
            else:
                n_up = self.upsample_times - (self.end_level - i)
                for j in range(i):
                    x = getattr(self, f"l{i}_conv{j}")(x)
                    if j < n_up:
                        x = upsample2x(x)
            mlvl.append(x)
        # inputs whose H/W aren't divisible by 32 give off-by-one level sizes
        target_hw = tuple(mlvl[0].shape[1:3])
        fused = mlvl[0]
        for m in mlvl[1:]:
            fused = fused + resize_bilinear(m, target_hw)
        outs = [self.conv_pred(fused)]
        for k in range(self.num_aux_convs):
            outs.append(getattr(self, f"aux_conv{k}")(fused))
        return outs
