"""Swin Transformer backbone, NHWC.

Counterpart of `video_knet_tpu/models/swin.py`: a 4x4 patch embed, four
stages of shifted-window attention blocks with a relative position bias,
patch merging between stages, a LayerNorm on each stage output (strides 4,
8, 16, 32; widths D, 2D, 4D, 8D). Presets tiny / small / base / large.

Module names mirror the flax ones. The reference scans each stage over
[no-shift, shift] block pairs, so its parameters carry a leading pair axis;
here pair k of stage s is `stage{s}_pairs.{k}` and `utils/convert.py`
unstacks and restacks that axis.

Numerics follow the reference:
- every LayerNorm is flax's default one-pass form (eps 1e-5);
- a block zero-pads its normed input to a multiple of the window; the shift
  (ws // 2, odd blocks) applies only when the padded map exceeds the window
  in both dims, and the -100 mask's region bands come from the padded size;
- attention is plain fp32 matmul + softmax: q scaled first, then the
  relative-position bias, then the mask (no fused attention, whose backends
  add the bias in another order);
- the MLP's GELU is exact.

Stochastic depth (training) draws one keep mask per sample from the
`generator` the caller passes; without one it is off. `frozen_stages` cuts
the gradient where the reference's `stop_gradient` does (after the patch
embed when >= 0, after stage s's downsample when >= s + 1) but leaves
`requires_grad` on: the reference's optimizer mask knows only ResNet's
names, so those parameters still take weight decay there, and here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import Conv2d, FastVarianceLayerNorm, resize_bilinear
from video_knet_tpu_torch.parallel.mesh import batch_uniform

SWIN_PRESETS = {
    # embed_dim, depths, num_heads
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ws*ws, C] (H, W divisible by ws)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, x.shape[-1])


def relative_position_index(ws: int) -> torch.Tensor:
    """[ws*ws, ws*ws] index into the (2ws-1)^2-row bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_attn_mask(h: int, w: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """Additive mask [nW, ws*ws, ws*ws]: -100 between tokens of different
    cyclic-shift regions (region = 3 * band(row) + band(col))."""
    def band(n: int) -> torch.Tensor:
        # [0, n-ws) -> 0, [n-ws, n-shift) -> 1, [n-shift, n) -> 2
        idx = torch.arange(n, device=device)
        return (idx >= n - ws).long() + (idx >= n - shift).long()

    region = band(h)[:, None] * 3 + band(w)[None, :]
    wins = region.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    same = wins[:, None, :] == wins[:, :, None]
    zero = torch.zeros((), device=device)
    return torch.where(same, zero, zero - 100.0)


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Residual-branch stochastic depth: one Bernoulli keep draw a sample,
    scaled by 1 / keep. Off (the identity) without a generator. Under data
    parallelism the draws cover the global batch (`parallel/mesh.py:
    batch_uniform`)."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = batch_uniform(x.shape[0], generator, x.device).reshape(shape) < keep
    return x * mask.to(x.dtype) / keep


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        # computed, not learned: no flax leaf and no checkpoint entry
        self.register_buffer("relative_position_index",
                             relative_position_index(window_size).reshape(-1), persistent=False)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        # flax's truncated_normal(0.02)
        std = 0.02 / 0.87962566103423978
        nn.init.trunc_normal_(self.relative_position_bias_table, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """x [nW*B, N, C]; mask [nW, N, N] additive, or None."""
        bw, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).reshape(bw, n, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [bw, h, n, d]
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n) + mask[None, :, None]).reshape(bw, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, drop_path: float,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.drop_path = drop_path
        self.norm1 = FastVarianceLayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = FastVarianceLayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None,
                generator: torch.Generator | None) -> torch.Tensor:
        """x [B, H, W, C]; `mask` given: the shifted block (shift ws // 2)."""
        b, h, w, c = x.shape
        ws = self.window_size
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        hp, wp = h + pad_h, w + pad_w
        shift = ws // 2 if mask is not None else 0
        y = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + drop_path(y[:, :h, :w], self.drop_path, generator)
        z = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + drop_path(z, self.drop_path, generator)


class SwinBlockPair(nn.Module):
    """One [no-shift, shift] block pair: the reference's scan body."""

    def __init__(self, dim: int, num_heads: int, window_size: int, rates: tuple[float, float]):
        super().__init__()
        self.blk0 = SwinBlock(dim, num_heads, window_size, rates[0])
        self.blk1 = SwinBlock(dim, num_heads, window_size, rates[1])

    def forward(self, x, mask, generator):
        return self.blk1(self.blk0(x, None, generator), mask, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = FastVarianceLayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Returns the four stage outputs (strides 4, 8, 16, 32), NHWC; their
    widths are `out_channels`."""

    def __init__(self, preset: str = "base", window_size: int = 7, frozen_stages: int = -1,
                 drop_path_rate: float = 0.0, ape: bool = False,
                 ape_shape: tuple[int, int] = (56, 56)):
        super().__init__()
        embed_dim, depths, num_heads = SWIN_PRESETS[preset]
        self.window_size = window_size
        self.frozen_stages = frozen_stages
        # the frozen stages are cut from the graph, their parameters left
        # trainable (optax decays them): the patch embedding's and the cut
        # downsamples' take no gradient
        self.leaves_parameters_unused = frozen_stages >= 0
        self.depths = depths
        self.out_channels = tuple(embed_dim * 2 ** s for s in range(4))
        self.patch_embed = Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = FastVarianceLayerNorm(embed_dim, eps=1e-5)
        self.ape = ape
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.empty(1, *ape_shape, embed_dim))
        # per-block stochastic-depth rates, linear over the total depth
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        dim, blk = embed_dim, 0
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            if depth % 2:
                raise ValueError("swin stages alternate shift / no-shift pairs")
            self.add_module(f"stage{s}_pairs", nn.ModuleList(
                SwinBlockPair(dim, heads, window_size, (rates[blk + 2 * k], rates[blk + 2 * k + 1]))
                for k in range(depth // 2)))
            self.add_module(f"out_norm{s}", FastVarianceLayerNorm(dim, eps=1e-5))
            if s < len(depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging(dim))
                dim *= 2
            blk += depth

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if self.ape:
            std = 0.02 / 0.87962566103423978
            nn.init.trunc_normal_(self.absolute_pos_embed, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """x [B, H, W, 3]; `generator` turns stochastic depth on (training)."""
        ws = self.window_size
        x = self.patch_norm(self.patch_embed(x))
        if self.ape:
            x = x + resize_bilinear(self.absolute_pos_embed, tuple(x.shape[1:3]))
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for s in range(len(self.depths)):
            hp, wp = (-(-n // ws) * ws for n in x.shape[1:3])
            # one mask a stage, shared by its shifted blocks
            mask = shift_attn_mask(hp, wp, ws, ws // 2, x.device) if min(hp, wp) > ws else None
            for pair in getattr(self, f"stage{s}_pairs"):
                x = pair(x, mask, generator)
            outs.append(getattr(self, f"out_norm{s}")(x))
            if s < len(self.depths) - 1:
                x = getattr(self, f"downsample{s}")(x)
            if self.frozen_stages >= s + 1:
                x = x.detach()
        return outs
