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

On a band of the image rows (the band split of the mesh's `model` axis,
`parallel/model_axis.py`) the layers that reach across rows compute what
the whole map's do on the band's rows, from the whole map's geometry:
convolutions and pools take the rows their windows read at the whole
map's padding, a bilinear upsampling by a whole factor the neighbour rows,
any other resize the source rows its output rows read, GroupNorm the whole
map's statistics. Each takes `bands`, every rank's rows of its input map,
where that map is not a level of the backbone (the Semantic-FPN's
upsampled maps); else it tells the level by its columns.

Submodules carry the flax module names (`Dense_0`, `LayerNorm_0`, ...), so
`utils/convert.py` maps a flax variables tree onto `state_dict` keys by path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.parallel.mesh import active_mesh, sum_with_grad
from video_knet_tpu_torch.parallel.model_axis import (
    band_slice,
    fetch_rows,
    in_band,
    level_bands,
    level_height,
    model_sum,
    neighbour_rows,
    scaled_bands,
    window_rows,
)

# ---------------------------------------------------------------- XLA helpers


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of XLA's "SAME" for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _nearest_index(m: int, n: int, device=None) -> torch.Tensor:
    """The source index of each of `n` outputs of `m` inputs:
    floor((i + 0.5) * m / n), computed in float32 as JAX computes it."""
    return ((torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n).floor().long()


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int], dims=(-2, -1)) -> torch.Tensor:
    """Nearest resize of the two `dims` of `x`, as `jax.image.resize(..., "nearest")`.

    Works on any dtype (labels included) by an index gather. On a band of
    NHWC features (`dims` (1, 2), the FPN's top-down resize) `out_hw` is
    the band of the output level, and each of its rows takes its source
    row of the whole input level, from the band that owns it."""
    band = in_band()
    if band is not None and tuple(dims) == (1, 2):
        x = _banded_nearest(x, out_hw, band)
        dims, out_hw = (2,), out_hw[1:]
    for d, n in zip(dims, out_hw):
        m = x.shape[d]
        if m == n:
            continue
        x = x.index_select(d, _nearest_index(m, n, x.device))
    return x


def _banded_nearest(x: torch.Tensor, out_hw: tuple[int, int], band) -> torch.Tensor:
    """The rows of NHWC band `x` (a level) that the whole level's nearest
    resize gives the band `out_hw` of the output level (its columns left
    as they are)."""
    src, out = (level_bands(*hw, band) for hw in (x.shape[1:3], out_hw))
    if src[-1][1] == out[-1][1]:
        return x
    idx = _nearest_index(src[-1][1], out[-1][1]).tolist()
    return fetch_rows(x, tuple(tuple(idx[a:b]) for a, b in out), band, bands=src)


def _interp_bilinear(x_nchw: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    shrinks = out_hw[0] < x_nchw.shape[-2] or out_hw[1] < x_nchw.shape[-1]
    # bf16 (the bf16 training forward) resizes in fp32 and rounds once:
    # PyTorch has no bf16 antialiased kernel on the CPU
    y = F.interpolate(
        x_nchw.float() if x_nchw.dtype == torch.bfloat16 else x_nchw, size=tuple(out_hw),
        mode="bilinear", align_corners=False, antialias=shrinks,
    )
    return y.to(x_nchw.dtype)


def _banded_resize(x: torch.Tensor, out_hw: tuple[int, int], band, src: tuple | None,
                   out: tuple | None = None) -> torch.Tensor:
    """The rows the whole map's bilinear resize gives this band, from NHWC
    band `x` of a map whose rows are `src` (default: a level's) to the map
    whose band here is `out_hw` (its rows `out`; default: a level's).
    - By a whole factor r of the rows (every rank's output rows r times its
      input rows), not shrinking the columns: the band with its neighbour
      rows, resized r times, its own output rows kept. Each kept row takes
      the whole map's source rows and weights (clamped only at the global
      top and bottom).
    - Any other resize (the Semantic-FPN's antialiased shrink of an
      upsampled level to the fused level, 48 -> 47 rows at 376): the source
      rows its output rows read (a superset of PyTorch's window, bilinear or
      antialiased), set at their global rows of a map of the whole input
      height (zero elsewhere), resized whole, its own output rows kept.
    Either way PyTorch's kernel runs the whole map's arithmetic on every
    kept row: the result is the whole map's, bit for bit."""
    src = level_bands(x.shape[1], x.shape[2], band) if src is None else src
    out = level_bands(*out_hw, band) if out is None else out
    h_in, h_out = src[-1][1], out[-1][1]
    if h_in == h_out and x.shape[2] == out_hw[1]:
        return x
    r = h_out // h_in
    if r * h_in == h_out and out == scaled_bands(src, r) and out_hw[1] >= x.shape[2]:
        y, top = neighbour_rows(x, band, src)
        h = x.shape[1]
        return _resize_nhwc(y, (r * y.shape[1], out_hw[1]))[:, r * top:r * (top + h)]
    scale = h_in / h_out

    def reads(o0: int, o1: int) -> tuple[int, int]:
        return (max(math.floor(scale * (o0 - 0.5)) - 1, 0),
                min(math.ceil(scale * (o1 + 0.5)) + 2, h_in))

    windows = [reads(*o) for o in out]
    y = fetch_rows(x, tuple(tuple(range(*w)) for w in windows), band, bands=src)
    first, end = windows[band.index]
    whole = F.pad(y, (0, 0, 0, 0, first, h_in - end))
    o0, o1 = out[band.index]
    return _resize_nhwc(whole, (h_out, out_hw[1]))[:, o0:o1]


def _resize_nhwc(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    return _interp_bilinear(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    bands: tuple | None = None) -> torch.Tensor:
    """Bilinear resize of NHWC features (align_corners=False). On a band,
    `out_hw` is the band of a level, and `bands` (if given) every rank's
    rows of `x`'s map (`_banded_resize`)."""
    if tuple(x.shape[1:3]) == tuple(out_hw) and bands is None:
        return x  # on a band too: a level's band of the same shape is the same level's
    band = in_band()
    if band is not None:
        return _banded_resize(x, out_hw, band, bands)
    return _resize_nhwc(x, out_hw)


def resize_mask_bilinear(m: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W] mask stacks, as NHWC features of one
    image with a channel a mask: PyTorch's channels-last kernel gives every
    output pixel the same arithmetic whatever the map's height, where its
    NCHW kernel on the CPU switches between two orders of operations with
    the size (a band's rows would round otherwise than the whole map's).
    At least 4 channels: fewer take the NCHW kernel."""
    if tuple(m.shape[-2:]) == tuple(out_hw):
        return m
    lead = m.shape[:-2]
    x = m.reshape(-1, *m.shape[-2:]).permute(1, 2, 0)[None]
    n = x.shape[-1]
    x = F.pad(x, (0, max(4 - n, 0))).contiguous()
    band = in_band()
    y = _resize_nhwc(x, out_hw) if band is None else _banded_resize(x, out_hw, band, None)
    return y[0, ..., :n].permute(2, 0, 1).reshape(*lead, *out_hw)


def upsample2x(x: torch.Tensor, bands: tuple | None = None) -> torch.Tensor:
    """`x` upsampled twice; on a band, every rank's rows twice its rows of
    `x`'s map (`bands`, default a level's: `model_axis.scaled_bands`)."""
    hw = (x.shape[1] * 2, x.shape[2] * 2)
    band = in_band()
    if band is None:
        return resize_bilinear(x, hw)
    src = level_bands(x.shape[1], x.shape[2], band) if bands is None else bands
    return _banded_resize(x, hw, band, src, scaled_bands(src, 2))


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
    `feature_group_count`. On a band of the image's rows (the band split of
    the mesh's `model` axis, `parallel/model_axis.py`) it pads the rows as
    the whole image's convolution does: the rows its window reaches past
    the band come from the neighbouring bands."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: str | int = "SAME", bias: bool = True, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride = stride
        self.padding = padding
        self.groups = groups

    def forward(self, x: torch.Tensor, bands: tuple | None = None) -> torch.Tensor:
        """`bands`: on a band, every rank's rows of `x`'s map where it is
        not a level of the backbone."""
        k = self.weight.shape[-1]
        if k == 1 and self.stride == 1 and self.groups == 1:
            return F.linear(x, self.weight[:, :, 0, 0], self.bias)
        band = in_band()
        if band is not None:
            return self._banded(x, band, bands)
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

    def _banded(self, x: torch.Tensor, band, bands: tuple | None) -> torch.Tensor:
        """The rows of the whole map's output that this band of `x` owns:
        the rows its windows read at the whole map's top and bottom padding
        (`model_axis.window_rows`: from the other bands, zero past the
        map's global top and bottom), the columns padded as usual."""
        k, s = self.weight.shape[-1], self.stride
        if bands is None:
            bands = level_bands(x.shape[1], x.shape[2], band)
        if self.padding == "SAME":
            lo, hi = same_padding(bands[-1][1], k, s)
            left, right = same_padding(x.shape[2], k, s)
        else:
            lo = hi = left = right = self.padding
        y = window_rows(x, bands, k, s, lo, hi, 0.0, band).permute(0, 3, 1, 2)
        if left != right:
            y, left = F.pad(y, (left, right, 0, 0)), 0
        y = F.conv2d(y, self.weight, self.bias, stride=s, padding=(0, left), groups=self.groups)
        return y.permute(0, 2, 3, 1)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """ResNet's stem pool on NHWC: 3x3, stride 2, padding 1 (-inf); on a
    band of the image's rows the rows its windows read past the band come
    from the other bands (-inf past the level's global top and bottom)."""
    band = in_band()
    if band is None:
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    bands = level_bands(x.shape[1], x.shape[2], band)
    y = window_rows(x, bands, 3, 2, 1, 1, float("-inf"), band).permute(0, 3, 1, 2)
    return F.max_pool2d(y, 3, stride=2, padding=(0, 1)).permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(use_fast_variance=False)` on NHWC: two-pass
    variance, eps 1e-5. As in flax, a bf16 input's statistics and
    normalization are computed in fp32 and the result takes the dtype of
    the input and parameters. On a band the statistics are the whole
    map's: the bands' sums for the mean, then their sums of squared
    deviations from it, each summed over the `model` group."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor, bands: tuple | None = None) -> torch.Tensor:
        """`bands`: as for `Conv2d`."""
        b, c = x.shape[0], x.shape[-1]
        g = _fp32(x).reshape(b, -1, self.num_groups, c // self.num_groups)
        if in_band() is None:
            mean = g.mean(dim=(1, 3), keepdim=True)
            d = g - mean
            var = (d * d).mean(dim=(1, 3), keepdim=True)
        else:
            rows = level_height(*x.shape[1:3]) if bands is None else bands[-1][1]
            count = rows * x.shape[2] * g.shape[3]
            mean = model_sum(g.sum(dim=(1, 3), keepdim=True)) / count
            d = g - mean
            var = model_sum((d * d).sum(dim=(1, 3), keepdim=True)) / count
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

    def forward(self, x: torch.Tensor, bands: tuple | None = None) -> torch.Tensor:
        """`bands`: as for `Conv2d` (the output has the input's rows: the
        stride-1 maps of the Semantic-FPN that take them)."""
        y = self.Conv_0(x, bands)
        return F.relu(self.GroupNorm_0(y, bands if self.Conv_0.stride == 1 else None))


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


def band_positional_encoding(h: int, w: int, num_feats: int = 128,
                             device=None) -> torch.Tensor:
    """`sine_positional_encoding` of a level whose band (or whole map,
    outside the band split) has `h` rows: the whole level's code, at the
    band's global rows."""
    pe = sine_positional_encoding(level_height(h, w), w, num_feats, device=device)
    return band_slice(pe, 0)


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
