"""DetectoRS components, NHWC: SAC, the RFP-capable ResNet and Swin, and
the recursive feature pyramid over them.

Counterpart of `video_knet_tpu/models/rfp.py`:
- `SAConv`: switchable atrous convolution. One 3x3 weight W runs at
  dilation 1 and W + dW at dilation 3; a sigmoid switch (a 1x1 conv over
  the 5x5 average-pooled input) mixes the two; a global-context 1x1 is
  added before and after.
- `DetectoRSResNet`: a ResNet whose stages 2-4 use SAC and whose first
  block of stages 2-4 adds `rfp_conv(rfp_feat)` before its last ReLU.
- `SwinTransformerRFP`: a Swin whose stages 1-3 add `rfp_conv{s}(rfp_feat)`
  after their blocks, before the stage's out norm and patch merging. Its
  blocks are not scanned in the reference: they are `stage{s}_block{b}`.
- `RFP`: two passes of one backbone and one FPN (the same modules, so the
  gradients of both passes add); the second pass feeds FPN level s back
  into backbone stage s + 1 and fuses old and new levels with a per-level
  sigmoid weight. Its output is the 256-wide 4-level pyramid, so a model
  over it has no neck.

Numerics follow the reference: the DetectoRS stem pads (3, 3) and its max
pool (1, 1) with -inf, symmetric; SAC's convolutions pad (d, d)
symmetrically even at stride 2, while the plain conv2 pads as XLA's "SAME";
SAC's average pool counts the padded zeros.

On a band of the image rows (the band split of the mesh's `model` axis,
`parallel/model_axis.py`) every layer gives the whole map's rows of this
band: SAC's two global means are the band's sums, summed over the `model`
group, over the whole map's pixels; its 5x5 pool and its dilated convs
read the rows their windows reach past the band (2 rows for the pool, d
for the conv at dilation d) from the other bands at the whole map's
padding (`model_axis.window_rows`), the stride-2 SACs' bands all starting
on an even row; the stem's max pool is ResNet's banded one; the Swin pads
and shifts its windows by the whole map's height; the 1x1 convs, the
frozen BatchNorm, the FPN, the feedback of FPN level s into stage s + 1
(the same stride, so the band's own rows) and the fusion are band-local
or banded already. `RFP` builds its backbones with
the reference's defaults whatever the model config says: the DetectoRS
ResNet with `frozen_stages=1` (the activations leaving the stem and layer1
are cut from the graph; their parameters stay trainable, as the
reference's optimizer mask does not know the `bb/` names, so they take
weight decay) and `norm_eval=True` (BatchNorm on its running averages
always); the Swin with no stochastic depth and no frozen stage.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    FastVarianceLayerNorm,
    max_pool_3x3_s2,
)
from video_knet_tpu_torch.models.resnet import FPN, RESNET_STAGE_BLOCKS
from video_knet_tpu_torch.models.swin import SWIN_PRESETS, PatchMerging, SwinBlock, shift_attn_mask
from video_knet_tpu_torch.parallel.model_axis import (
    in_band,
    level_bands,
    level_height,
    model_sum,
    window_rows,
)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SAConv(nn.Module):
    """Switchable atrous convolution; `weight` and `weight_diff` are OIHW
    (flax's `kernel` and `weight_diff`, HWIO)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.pre_context = Conv2d(in_ch, in_ch, 1)
        self.switch = Conv2d(in_ch, 1, 1, stride=stride)
        self.weight = nn.Parameter(torch.empty(features, in_ch, 3, 3))
        self.weight_diff = nn.Parameter(torch.empty(features, in_ch, 3, 3))
        self.post_context = Conv2d(features, features, 1)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        # flax's he_normal: variance_scaling(2, fan_in, truncated_normal); weight_diff zeros
        std = math.sqrt(2.0 / self.weight[0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.weight_diff.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        band = in_band()
        x = x + self.pre_context(_global_mean(x, band))
        # a contiguous NCHW input: the CUDA backward of avg_pool2d on a
        # channels-last view is wrong in PyTorch 2.11 (PERF.md section 6)
        pooled = _nhwc(F.avg_pool2d(_nchw(_rows_read(x, band, 5, 1, 2)).contiguous(), 5,
                                    stride=1, padding=(2 if band is None else 0, 2),
                                    count_include_pad=True))
        switch = torch.sigmoid(self.switch(pooled))
        near = self._dilated(x, self.weight, 1, band)
        far = self._dilated(x, self.weight + self.weight_diff, 3, band)
        out = switch * near + (1.0 - switch) * far
        return out + self.post_context(_global_mean(out, band))

    def _dilated(self, x: torch.Tensor, weight: torch.Tensor, d: int, band) -> torch.Tensor:
        """The 3x3 conv at dilation `d`, padded (d, d); on a band, run on
        the rows its windows read (2d + 1 a window) with no row padding."""
        y = _nchw(_rows_read(x, band, 2 * d + 1, self.stride, d))
        return _nhwc(F.conv2d(y, weight, stride=self.stride, padding=(d if band is None else 0, d),
                              dilation=d))


def _global_mean(x: torch.Tensor, band) -> torch.Tensor:
    """NHWC `x`'s mean over the map's pixels, [B, 1, 1, C]; on a band the
    band's sum summed over the `model` group over the whole map's pixels."""
    if band is None:
        return x.mean(dim=(1, 2), keepdim=True)
    rows, cols = x.shape[1:3]
    return model_sum(x.sum(dim=(1, 2), keepdim=True)) / (level_height(rows, cols) * cols)


def _rows_read(x: torch.Tensor, band, k: int, s: int, pad: int) -> torch.Tensor:
    """`x` itself off a band; on one, the rows of the whole map that a
    `k`-row window at stride `s` over the map padded by `pad` zero rows on
    either side reads for this band's output rows (`model_axis.window_rows`)."""
    if band is None:
        return x
    return window_rows(x, level_bands(*x.shape[1:3], band), k, s, pad, pad, 0.0, band)


class DetectoRSBottleneck(nn.Module):
    """Bottleneck with SAC as its 3x3 conv (`with_sac`) and an RFP input
    (`with_rfp`): `rfp_conv(rfp_feat)` joins the residual sum before the
    last ReLU when a feature is given."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, with_sac: bool = False,
                 with_rfp: bool = False, rfp_channels: int = 256):
        super().__init__()
        self.with_sac = with_sac
        self.with_rfp = with_rfp
        self.conv1 = Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        if with_sac:
            self.sac = SAConv(features, features, stride)
        else:
            self.conv2 = Conv2d(features, features, 3, stride=stride, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = BatchNorm(features * 4)
        self.has_downsample = in_ch != features * 4 or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, features * 4, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(features * 4)
        if with_rfp:
            self.rfp_conv = Conv2d(rfp_channels, features * 4, 1)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if self.with_rfp:
            self.rfp_conv.weight.zero_()

    def forward(self, x: torch.Tensor, rfp_feat: torch.Tensor | None = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.sac(y) if self.with_sac else self.conv2(y)
        y = F.relu(self.bn2(y))
        y = self.bn3(self.conv3(y))
        y = y + (self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x)
        if self.with_rfp and rfp_feat is not None:
            y = y + self.rfp_conv(rfp_feat)
        return F.relu(y)


class DetectoRSResNet(nn.Module):
    """Returns the four stage outputs (strides 4, 8, 16, 32). `rfp_feats`,
    when given, holds one map a stage; stage 1's entry is not read."""

    def __init__(self, depth: int = 50, sac_stages=(2, 3, 4), frozen_stages: int = 1):
        super().__init__()
        self.frozen_stages = frozen_stages
        widths = (64, 128, 256, 512)
        self.out_channels = tuple(w * 4 for w in widths)
        self.stage_blocks = RESNET_STAGE_BLOCKS[depth]
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for s, (w, n_blocks) in enumerate(zip(widths, self.stage_blocks), start=1):
            for b in range(n_blocks):
                self.add_module(f"layer{s}_block{b}", DetectoRSBottleneck(
                    in_ch, w, stride=2 if (b == 0 and s > 1) else 1,
                    with_sac=s in sac_stages, with_rfp=(b == 0 and s > 1)))
                in_ch = w * 4

    def forward(self, x: torch.Tensor,
                rfp_feats: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
        y = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        if self.frozen_stages >= 0:
            y = y.detach()
        outs = []
        for s, n_blocks in enumerate(self.stage_blocks, start=1):
            rfp = rfp_feats[s - 1] if (rfp_feats is not None and s > 1) else None
            for b in range(n_blocks):
                y = getattr(self, f"layer{s}_block{b}")(y, rfp)
            if self.frozen_stages >= s:
                y = y.detach()
            outs.append(y)
        return outs


class SwinTransformerRFP(nn.Module):
    """Swin (no stochastic depth) with an RFP input after stages 1-3.
    Returns the four normed stage outputs (strides 4, 8, 16, 32)."""

    def __init__(self, preset: str = "base", window_size: int = 7, rfp_channels: int = 256):
        super().__init__()
        embed_dim, depths, num_heads = SWIN_PRESETS[preset]
        self.window_size = window_size
        self.depths = depths
        self.out_channels = tuple(embed_dim * 2 ** s for s in range(4))
        self.patch_embed = Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = FastVarianceLayerNorm(embed_dim, eps=1e-5)
        dim = embed_dim
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", SwinBlock(dim, heads, window_size, 0.0))
            if s > 0:
                self.add_module(f"rfp_conv{s}", Conv2d(rfp_channels, dim, 1))
            self.add_module(f"out_norm{s}", FastVarianceLayerNorm(dim, eps=1e-5))
            if s < len(depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging(dim))
                dim *= 2

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        for s in range(1, len(self.depths)):
            getattr(self, f"rfp_conv{s}").weight.zero_()

    def forward(self, x: torch.Tensor,
                rfp_feats: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
        ws = self.window_size
        x = self.patch_norm(self.patch_embed(x))
        outs = []
        for s, depth in enumerate(self.depths):
            # the whole map's padded size, on a band too
            hp, wp = (-(-n // ws) * ws for n in (level_height(*x.shape[1:3]), x.shape[2]))
            # the shifted (odd) blocks shift only when the padded map exceeds the window
            mask = shift_attn_mask(hp, wp, ws, ws // 2, x.device) if min(hp, wp) > ws else None
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x, mask if b % 2 else None, None)
            if rfp_feats is not None and s > 0:
                x = x + getattr(self, f"rfp_conv{s}")(rfp_feats[s])
            outs.append(getattr(self, f"out_norm{s}")(x))
            if s < len(self.depths) - 1:
                x = getattr(self, f"downsample{s}")(x)
        return outs


def rfp_backbone_name(name: str) -> str:
    """A model config's RFP backbone name -> the reference RFP's own:
    `swin_b_rfp` / `swin_t_rfp` -> `swin_base_rfp` / `swin_tiny_rfp`."""
    if not name.startswith("swin"):
        return name
    preset = name.split("_")[1]
    return f"swin_{dict(b='base', t='tiny').get(preset, preset)}_rfp"


class RFP(nn.Module):
    """Recursive feature pyramid over `backbone` ('detectors_r50' /
    'detectors_r101' / 'swin_<preset>_rfp'), `rfp_steps` passes. Returns the
    four 256-wide levels (strides 4, 8, 16, 32)."""

    def __init__(self, backbone: str = "detectors_r50", rfp_steps: int = 2):
        super().__init__()
        self.rfp_steps = rfp_steps
        if backbone.startswith("detectors"):
            self.bb = DetectoRSResNet(depth=int(backbone.split("_r")[-1]))
        else:
            self.bb = SwinTransformerRFP(preset=backbone.replace("swin_", "").replace("_rfp", ""))
        self.fpn = FPN(in_channels=self.bb.out_channels)
        self.out_channels = (self.fpn.out_channels,) * 4
        for i in range(4):
            self.add_module(f"fusion_weight{i}", Conv2d(self.fpn.out_channels, 1, 1))
        # the DetectoRS stem and layer1 take no gradient (their activations
        # are cut); the optimizer still decays them
        self.leaves_parameters_unused = isinstance(self.bb, DetectoRSResNet)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """`generator` is ignored: the reference builds these backbones
        without stochastic depth."""
        levels = self.fpn(self.bb(x))[:4]
        for _ in range(self.rfp_steps - 1):
            new_levels = self.fpn(self.bb(x, rfp_feats=levels))[:4]
            fused = []
            for i, (old, new) in enumerate(zip(levels, new_levels)):
                w = torch.sigmoid(getattr(self, f"fusion_weight{i}")(new))
                fused.append(w * new + (1.0 - w) * old)
            levels = fused
        return levels
