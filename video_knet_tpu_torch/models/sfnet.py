"""The SFNet aligned semantic head and the STDC backbone, NHWC.

Counterpart of `video_knet_tpu/models/sfnet.py`:
- `grid_sample_bilinear`: torch's `grid_sample(align_corners=True,
  padding_mode='zeros')` as the reference writes it: four clipped gathers
  weighted by (1 - |dx|)(1 - |dy|) and a validity mask, summed in its order
  (dx outer, dy inner).
- `AlignedModule` (`align_type='v1'`): the coarse feature warped onto the
  fine grid by a learned flow (a 3x3 conv over the concatenated 1x1-reduced
  features); the base grid is `linspace(-1, 1, n)` and the flow is divided
  by the output size. `AlignedModuleV2PoolingAtten` (`'v2'`): two flows,
  both features warped, fused by a sigmoid gate over channel mean / max
  statistics.
- `UperNetAlignHead`: the top-down pathway whose upsampling is the aligned
  warp, every level summed at the stride-8 size (the stride-4 level is
  downsized with antialiasing, as `jax.image.resize` does), the sine
  positional encoding, a deformable 3x3 conv as its main output and 3x3
  aux convs; `ConvKernelHead`'s `fpn_type='upernet_align'`.
- `STDCNet`: the STDC backbone (ConvX stem + CatBottleneck stages) at
  strides 4, 8, 16, 32. No model builds it; the reference has it as a
  component.

Every BatchNorm here normalizes with its running averages, in training
too, as the reference's do (`use_running_average=True`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.deform_conv import DeformConv2d
from video_knet_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    resize_bilinear,
    same_padding,
    sine_positional_encoding,
)


def grid_sample_bilinear(x: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """x [B, h, w, C]; gx / gy [B, H, W] normalized coordinates in [-1, 1]
    (align_corners) -> [B, H, W, C], zero outside the map."""
    b, h, w, c = x.shape
    ix = (gx + 1.0) * 0.5 * (w - 1)
    iy = (gy + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    flat = x.reshape(b * h * w, c)
    base = (torch.arange(b, device=x.device) * (h * w))[:, None, None]
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            wgt = (1 - (ix - xi).abs()) * (1 - (iy - yi).abs())
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long() + base
            term = flat[idx] * (wgt * valid)[..., None]
            out = term if out is None else out + term
    return out


def _base_grid(hh: int, ww: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The align-corners base grid (gy, gx), each [H, W]."""
    gy = torch.linspace(-1.0, 1.0, hh, device=device)[:, None].expand(hh, ww)
    gx = torch.linspace(-1.0, 1.0, ww, device=device)[None, :].expand(hh, ww)
    return gy, gx


class AlignedModule(nn.Module):
    """`low` fine [B, H, W, C_l], `high` coarse [B, h, w, C_h] -> `high`
    warped onto [B, H, W, C_h]."""

    def __init__(self, low_ch: int, high_ch: int, outplane: int, flows: int = 1):
        super().__init__()
        self.down_l = Conv2d(low_ch, outplane, 1, bias=False)
        self.down_h = Conv2d(high_ch, outplane, 1, bias=False)
        self.flow_make = Conv2d(2 * outplane, 2 * flows, 3, bias=False)

    def _flow(self, low: torch.Tensor, high: torch.Tensor):
        hh, ww = low.shape[1:3]
        l = self.down_l(low)
        g = resize_bilinear(self.down_h(high), (hh, ww))
        return g, self.flow_make(torch.cat([g, l], dim=-1))

    @staticmethod
    def _warp(x: torch.Tensor, flow: torch.Tensor, base) -> torch.Tensor:
        hh, ww = flow.shape[1:3]
        gy, gx = base
        return grid_sample_bilinear(x, gx[None] + flow[..., 0] / ww, gy[None] + flow[..., 1] / hh)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        _, flow = self._flow(low, high)
        return self._warp(high, flow, _base_grid(*low.shape[1:3], low.device))


class AlignedModuleV2PoolingAtten(AlignedModule):
    """Both features warped onto the fine grid and fused by a spatial gate."""

    def __init__(self, low_ch: int, high_ch: int, outplane: int):
        super().__init__(low_ch, high_ch, outplane, flows=2)
        self.flow_gate = Conv2d(4, 1, 3, bias=False)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        g, flow = self._flow(low, high)
        base = _base_grid(*low.shape[1:3], low.device)
        warp_h = self._warp(high, flow[..., 0:2], base)
        warp_l = self._warp(low, flow[..., 2:4], base)
        stats = torch.cat([g.mean(dim=-1, keepdim=True), low.mean(dim=-1, keepdim=True),
                           g.amax(dim=-1, keepdim=True), low.amax(dim=-1, keepdim=True)], dim=-1)
        gate = torch.sigmoid(self.flow_gate(stats))
        return warp_h * gate + warp_l * (1.0 - gate)


class UperNetAlignHead(nn.Module):
    """Aligned top-down head over four `in_channels`-wide levels; returns
    [main, aux...] at the stride-8 level's size, like `SemanticFPN`."""

    def __init__(self, in_channels: int = 256, out_channels: int = 256, num_aux_convs: int = 1,
                 with_positional_encoding: bool = True, align_type: str = "v1"):
        super().__init__()
        if align_type not in ("v1", "v2"):
            raise ValueError(f"align_type={align_type!r}")
        self.out_channels = out_channels
        self.num_aux_convs = num_aux_convs
        self.with_positional_encoding = with_positional_encoding
        align_cls = AlignedModule if align_type == "v1" else AlignedModuleV2PoolingAtten
        for i in reversed(range(3)):
            self.add_module(f"fpn_in{i}", Conv2d(in_channels, out_channels, 1))
            self.add_module(f"fpn_in_bn{i}", BatchNorm(out_channels))
            # the top-down feature is the raw top level first, then a sum of laterals
            high = in_channels if i == 2 else out_channels
            self.add_module(f"align{i}", align_cls(out_channels, high, out_channels // 2))
            self.add_module(f"fpn_out{i}", Conv2d(out_channels, out_channels, 3))
            self.add_module(f"fpn_out_bn{i}", BatchNorm(out_channels))
        self.dcn_out = DeformConv2d(out_channels, out_channels)
        for k in range(num_aux_convs):
            self.add_module(f"aux_conv{k}", Conv2d(out_channels, out_channels, 3))

    def forward(self, feats: Sequence[torch.Tensor],
                num_frames: int | None = None) -> list[torch.Tensor]:
        if num_frames is not None:
            raise ValueError(
                "fpn_type='upernet_align' has no 3-D temporal positional encoding; clip (VIS, "
                "num_frames) inputs require fpn_type='semantic_fpn'")
        feats = list(feats)[:4]
        f = feats[-1]
        pyramid = [f]
        for i in reversed(range(len(feats) - 1)):
            lateral = F.relu(getattr(self, f"fpn_in_bn{i}")(getattr(self, f"fpn_in{i}")(feats[i])))
            f = lateral + getattr(self, f"align{i}")(lateral, f)
            pyramid.append(getattr(self, f"fpn_out_bn{i}")(getattr(self, f"fpn_out{i}")(f)))
        hh, ww = feats[1].shape[1:3]
        fused = None
        for p in pyramid:
            p = resize_bilinear(p, (hh, ww))
            fused = p if fused is None else fused + p
        if self.with_positional_encoding:
            fused = fused + sine_positional_encoding(
                hh, ww, self.out_channels // 2, device=fused.device)[None]
        return [self.dcn_out(fused)] + [getattr(self, f"aux_conv{k}")(fused)
                                        for k in range(self.num_aux_convs)]


class ConvX(nn.Module):
    """Conv ("SAME", no bias) -> BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(in_ch, features, kernel, stride=stride, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def avg_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax `avg_pool(padding="SAME")` on NHWC: XLA's padding, the padded
    zeros counted."""
    (t, b), (l, r) = (same_padding(s, kernel, stride) for s in x.shape[1:3])
    # a contiguous NCHW input: the CUDA backward of avg_pool2d on a
    # channels-last view is wrong in PyTorch 2.11 (`models/rfp.py:SAConv`)
    y = F.pad(x.permute(0, 3, 1, 2).contiguous(), (l, r, t, b)).contiguous()
    return F.avg_pool2d(y, kernel, stride=stride).permute(0, 2, 3, 1)


class CatBottleneck(nn.Module):
    """STDC's cat-fusion block: a 1x1 ConvX, then `block_num - 1` 3x3 ConvX
    of halving width, all outputs concatenated (the first average-pooled at
    stride 2, the second branch's input downsampled by a depthwise conv)."""

    def __init__(self, in_ch: int, out_planes: int, block_num: int = 4, stride: int = 1):
        super().__init__()
        o = out_planes
        self.block_num = block_num
        self.stride = stride
        self.conv0 = ConvX(in_ch, o // 2, kernel=1)
        if stride == 2:
            self.avd_conv = Conv2d(o // 2, o // 2, 3, stride=2, bias=False, groups=o // 2)
            self.avd_bn = BatchNorm(o // 2)
        width = o // 2
        for idx in range(1, block_num):
            if idx == 1:
                out = o // 2 if block_num == 2 else o // 4
            elif idx < block_num - 1:
                out = o // 2 ** (idx + 1)
            else:
                out = o // 2 ** idx
            self.add_module(f"conv{idx}", ConvX(width, out))
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv0(x)
        cur = out1
        outs = []
        for idx in range(1, self.block_num):
            if idx == 1 and self.stride == 2:
                cur = self.avd_bn(self.avd_conv(cur))
            cur = getattr(self, f"conv{idx}")(cur)
            outs.append(cur)
        if self.stride == 2:
            out1 = avg_pool_same(out1, 3, 2)
        return torch.cat([out1] + outs, dim=-1)


class STDCNet(nn.Module):
    """STDCNet813 (`layers=(2, 2, 2)`) / STDCNet1446 (`(4, 5, 3)`); returns
    the features at strides 4, 8, 16, 32 (widths base, 4 base, 8 base,
    16 base)."""

    def __init__(self, base: int = 64, layers: Sequence[int] = (2, 2, 2), block_num: int = 4):
        super().__init__()
        self.layers = tuple(layers)
        self.stem0 = ConvX(3, base // 2, stride=2)
        self.stem1 = ConvX(base // 2, base, stride=2)
        in_ch = base
        for i, n_blocks in enumerate(self.layers):
            for j in range(n_blocks):
                out_planes = base * 2 ** (i + 2)
                self.add_module(f"stage{i}_block{j}", CatBottleneck(
                    in_ch, out_planes, block_num=block_num, stride=2 if j == 0 else 1))
                in_ch = out_planes
        self.out_channels = (base,) + tuple(base * 2 ** (i + 2) for i in range(len(self.layers)))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        y = self.stem1(self.stem0(x))
        outs = [y]
        for i, n_blocks in enumerate(self.layers):
            for j in range(n_blocks):
                y = getattr(self, f"stage{i}_block{j}")(y)
            outs.append(y)
        return outs
