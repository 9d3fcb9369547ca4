"""Common building blocks, NHWC at every public boundary.

Counterpart of `video_knet_tpu/models/layers.py`. Convolutions run on NCHW
views of NHWC tensors. Three helpers reproduce what XLA does where PyTorch's
defaults differ:

- `same_padding`: XLA's "SAME" pads a strided convolution asymmetrically
  (lo = total // 2); `padding=k // 2` would shift the output by a pixel.
- `resize_nearest`: `jax.image.resize(..., "nearest")`, i.e. source index
  floor((i + 0.5) * in / out) computed in float32 (torch's "nearest-exact").
- `resize_bilinear` / `resize_mask_bilinear`: `jax.image.resize(..., "linear")`
  antialiases when it shrinks, which torch matches only with `antialias=True`.

Submodules carry the flax module names (`Dense_0`, `LayerNorm_0`, ...), so
`utils/convert.py` maps a flax variables tree onto `state_dict` keys by path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.parallel.mesh import active_mesh, sum_with_grad

# ---------------------------------------------------------------- XLA helpers


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of XLA's "SAME" for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int], dims=(-2, -1)) -> torch.Tensor:
    """Nearest resize of the two `dims` of `x`, as `jax.image.resize(..., "nearest")`.

    Works on any dtype (labels included) by an index gather."""
    for d, n in zip(dims, out_hw):
        m = x.shape[d]
        if m == n:
            continue
        idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n)
        x = x.index_select(d, idx.floor().long())
    return x


def _interp_bilinear(x_nchw: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    shrinks = out_hw[0] < x_nchw.shape[-2] or out_hw[1] < x_nchw.shape[-1]
    # bf16 (the bf16 training forward) resizes in fp32 and rounds once:
    # PyTorch has no bf16 antialiased kernel on the CPU
    y = F.interpolate(
        x_nchw.float() if x_nchw.dtype == torch.bfloat16 else x_nchw, size=tuple(out_hw),
        mode="bilinear", align_corners=False, antialias=shrinks,
    )
    return y.to(x_nchw.dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC features (align_corners=False)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return _interp_bilinear(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def resize_mask_bilinear(m: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W] mask stacks."""
    if tuple(m.shape[-2:]) == tuple(out_hw):
        return m
    lead = m.shape[:-2]
    y = _interp_bilinear(m.reshape(1, -1, *m.shape[-2:]), out_hw)
    return y.reshape(*lead, *out_hw)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2))


# ------------------------------------------------------------------- modules


def _fp32(x: torch.Tensor) -> torch.Tensor:
    """flax's norms reduce in at least fp32: bf16 -> fp32, fp32 unchanged."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _result_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The dtype flax gives a norm's output: that of its input and params."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


class Conv2d(nn.Module):
    """flax `nn.Conv` on NHWC: weight OIHW, "SAME" padding as XLA pads it
    (or explicit symmetric `padding`); `groups` is flax's
    `feature_group_count`."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: str | int = "SAME", bias: bool = True, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride = stride
        self.padding = padding
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if k == 1 and self.stride == 1 and self.groups == 1:
            return F.linear(x, self.weight[:, :, 0, 0], self.bias)
        y = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            (t, b), (l, r) = (same_padding(s, k, self.stride) for s in y.shape[-2:])
            if t == b and l == r:
                pad = (t, l)
            else:
                y = F.pad(y, (l, r, t, b))
                pad = 0
        else:
            pad = self.padding
        y = F.conv2d(y, self.weight, self.bias, stride=self.stride, padding=pad,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(use_fast_variance=False)` on NHWC: two-pass
    variance, eps 1e-5. As in flax, a bf16 input's statistics and
    normalization are computed in fp32 and the result takes the dtype of
    the input and parameters."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = _fp32(x).reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        d = g - mean
        var = (d * d).mean(dim=(1, 3), keepdim=True)
        y = (d * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(_result_dtype(x, self.weight, self.bias))


class FastVarianceLayerNorm(nn.Module):
    """flax `nn.LayerNorm` as it runs by default (`use_fast_variance=True`):
    var = max(mean(x^2) - mean(x)^2, 0), and the scale folded into the
    rsqrt before it multiplies (x - mean). Statistics in fp32 for a bf16
    input, as in flax."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = _fp32(x)
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(_result_dtype(x, self.weight, self.bias))


class BatchNorm(nn.Module):
    """BatchNorm on NHWC: flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`.

    Running averages (the default, and always in eval mode): the inference
    normalization. Live (`use_running_average=False` in training mode, the
    reference's `use_running_average=False`): flax's one-pass statistics
    over N, H and W in fp32, mean = E[x] and the biased var = max(E[x^2] -
    mean^2, 0), normalized as (x - mean) * (rsqrt(var + eps) * scale) + bias
    with gradients through mean, var and the clamp; the running averages
    then move to 0.9 * running + 0.1 * statistic (the same biased var;
    torch's `momentum=0.1`), outside the graph. Under data parallelism the
    moments sum over every rank first (`parallel/mesh.py:sum_with_grad`),
    so the statistics are the global batch's, as under JAX's mesh."""

    def __init__(self, channels: int, eps: float = 1e-5, use_running_average: bool = True):
        super().__init__()
        self.eps = eps
        self.use_running_average = use_running_average
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and not self.use_running_average:
            return self._live(x)
        y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.permute(0, 2, 3, 1)

    def _live(self, x: torch.Tensor) -> torch.Tensor:
        x32 = _fp32(x)
        c = x32.shape[-1]
        moments = torch.cat([x32.sum(dim=(0, 1, 2)), (x32 * x32).sum(dim=(0, 1, 2))])
        count = x32.numel() // c
        if active_mesh() is not None:
            moments = sum_with_grad(torch.cat([moments, moments.new_full((1,), count)]))
            count = moments[-1]
        mean, mean2 = moments[:c] / count, moments[c:2 * c] / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + (1 - 0.9) * mean.detach())
            self.running_var.copy_(0.9 * self.running_var + (1 - 0.9) * var.detach())
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(_result_dtype(x, self.weight, self.bias))


class ConvNormAct(nn.Module):
    """Conv (no bias) -> GN -> ReLU (mmcv ConvModule, norm='gn'), NHWC: the
    only form the serving path uses."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, out_ch, kernel_size, stride, bias=False)
        self.GroupNorm_0 = GroupNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class MLP(nn.Module):
    """(Linear no bias -> LN -> ReLU) x num_layers."""

    def __init__(self, num_layers: int, in_features: int, features: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", nn.Linear(in_features if i == 0 else features,
                                                    features, bias=False))
            self.add_module(f"LayerNorm_{i}", nn.LayerNorm(features, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = F.relu(getattr(self, f"LayerNorm_{i}")(x))
        return x


class FFN(nn.Module):
    """Linear-ReLU-Linear with the identity residual (mmcv FFN)."""

    def __init__(self, in_features: int, hidden: int = 2048, out: int = 256):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.Dense_1(F.relu(self.Dense_0(x)))


class MultiHeadAttention(nn.Module):
    """flax `MultiHeadDotProductAttention` (no mask, no dropout): q/k/v
    projections per head, 1/sqrt(head_dim) on the query, softmax, out
    projection. Plain matmuls; no residual (the caller adds it)."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        b, n, d = q_in.shape
        h = self.num_heads
        hd = d // h
        q = self.query(q_in).view(b, n, h, hd).transpose(1, 2)
        k = self.key(kv_in).view(b, -1, h, hd).transpose(1, 2)
        v = self.value(kv_in).view(b, -1, h, hd).transpose(1, 2)
        q = q / math.sqrt(hd)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        y = (w @ v).transpose(1, 2).reshape(b, n, d)
        return self.out(y)


def sine_positional_encoding(h: int, w: int, num_feats: int = 128,
                             device=None) -> torch.Tensor:
    """DETR-style normalized 2-D sine encoding -> [H, W, 2*num_feats]."""
    eps, scale, temperature = 1e-6, 2 * math.pi, 10000
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    y_embed = ones.cumsum(0)
    x_embed = ones.cumsum(1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_positional_encoding_3d(t: int, h: int, w: int, num_feats: int = 128,
                                device=None) -> torch.Tensor:
    """Clip encoding -> [T, H, W, 2*num_feats]: the 2-D code plus a temporal
    sine over the full channel width, added per frame."""
    eps, scale, temperature = 1e-6, 2 * math.pi, 10000
    spatial = sine_positional_encoding(h, w, num_feats, device=device)
    z = torch.arange(1, t + 1, dtype=torch.float32, device=device)
    z = z / (z[-1] + eps) * scale
    dim_z = torch.arange(2 * num_feats, dtype=torch.float32, device=device)
    dim_z = temperature ** (2 * torch.div(dim_z, 2, rounding_mode="floor") / (2 * num_feats))
    pos_z = z[:, None] / dim_z
    pos_z = torch.stack([pos_z[:, 0::2].sin(), pos_z[:, 1::2].cos()], dim=2).reshape(t, -1)
    return spatial[None] + pos_z[:, None, None, :]


# ------------------------------------------------------------ random init


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax's default kernel init: variance_scaling(1, fan_in, truncated_normal)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with flax's defaults, from one seeded generator, in module
    order: lecun-normal kernels, zero biases, unit norm scales, BN statistics
    (0, 1). Modules with their own initializers define `init_extra(generator)`."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, FastVarianceLayerNorm, GroupNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    for m in model.modules():
        if hasattr(m, "init_extra"):
            m.init_extra(generator)
