"""Semantic-FPN localization neck, NHWC.

Counterpart of `video_knet_tpu/models/semantic_fpn.py`: all four FPN levels
are convolved (+ upsampled) to the level-0/2 resolution and summed; two 1x1
heads give the 'thing' and 'stuff' branch features. Called with
`num_frames` (clip inputs [B*T, H, W, C], frames contiguous per video), the
last level's positional encoding gains the temporal term
(`sine_positional_encoding_3d`); the weights are the same either way.

Under the frame split of the mesh's `model` axis the leading axis holds
this rank's frames of each clip, and the temporal encoding added to them
is the whole clip's at their frames (`num_frames` stays the clip's
length). On a band of the image rows (the band split) the 3x3
convolutions take the rows their windows read, the stride-2 one pads at
the level's global height, the upsamplings take the neighbour rows, the
resizes to the fused level the source rows their output rows read, the
GroupNorms the whole map's statistics (`models/layers.py`), and the
positional encoding is the whole level's at the band's rows. Where the
height is not a multiple of 32 an upsampled level is not the next level
(at 720 rows: stride 32's 23 rows upsampled give 46, stride 16 has 45), so
the layers take its rows explicitly (`model_axis.scaled_bands`).
"""

from __future__ import annotations

import torch
from torch import nn

from video_knet_tpu_torch.models.layers import (
    ConvNormAct,
    band_positional_encoding,
    resize_bilinear,
    sine_positional_encoding_3d,
    upsample2x,
)
from video_knet_tpu_torch.parallel.model_axis import frame_slice, map_rows, scaled_bands


class SemanticFPN(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 out_channels: int = 256, upsample_times: int = 2, end_level: int = 3,
                 with_positional_encoding: bool = True, num_aux_convs: int = 1):
        super().__init__()
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

    def forward(self, feats: list[torch.Tensor],
                num_frames: int | None = None) -> list[torch.Tensor]:
        mlvl = []
        for i in range(self.end_level + 1):
            x = feats[i]
            if i == self.end_level and self.with_positional_encoding:
                h, w, c = x.shape[1:]
                if num_frames is None:
                    x = x + band_positional_encoding(h, w, c // 2, device=x.device)[None]
                else:
                    # the whole clip's code at this rank's frames (all of
                    # them outside the frame split)
                    pe = frame_slice(sine_positional_encoding_3d(
                        num_frames, h, w, c // 2, device=x.device), 0)
                    x = x + pe.repeat(x.shape[0] // pe.shape[0], 1, 1, 1)
            bands = map_rows(x)  # every rank's rows of x's map, on a band
            if i == 0:
                for j in range(self.end_level - self.upsample_times):
                    x = getattr(self, f"l0_conv{j}")(x)
                bands = None
            else:
                n_up = self.upsample_times - (self.end_level - i)
                for j in range(i):
                    x = getattr(self, f"l{i}_conv{j}")(x, bands)
                    if j < n_up:
                        x = upsample2x(x, bands)
                        bands = scaled_bands(bands, 2)
            mlvl.append((x, bands))
        # inputs whose H/W aren't divisible by 32 give off-by-one level sizes
        target_hw = tuple(mlvl[0][0].shape[1:3])
        fused = mlvl[0][0]
        for m, bands in mlvl[1:]:
            fused = fused + resize_bilinear(m, target_hw, bands)
        outs = [self.conv_pred(fused)]
        for k in range(self.num_aux_convs):
            outs.append(getattr(self, f"aux_conv{k}")(fused))
        return outs
