"""MixVisionTransformer (SegFormer mit_b0..b5) backbone, NHWC.

Counterpart of `video_knet_tpu/models/mit.py`: overlapping patch embeds
(7x7/4, then 3x3/2, XLA "SAME" padding), efficient self-attention with
spatial-reduction ratios (8, 4, 2, 1), Mix-FFN with a 3x3 depthwise conv and
exact GELU, LayerNorm everywhere, four stage outputs.

Numerics follow flax: every LayerNorm uses flax's fast variance; eps is
1e-6 except the spatial-reduction norm (`sr_norm`, 1e-5). The `sr` conv
(r x r, stride r) pads "SAME" like every flax conv here, so a stage whose
H or W is not a multiple of r is padded, not cropped. Attention is plain
fp32 einsum + softmax, as in the reference.

On a band of the image rows (the band split of the mesh's `model` axis,
`parallel/model_axis.py`) the patch embeds, the spatial reduction and the
Mix-FFN's depthwise conv take the rows their windows read through `Conv2d`
(at the whole level's "SAME" padding), and each block all-gathers its
reduced keys' and values' input over the `model` group in row order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import Conv2d, FastVarianceLayerNorm
from video_knet_tpu_torch.parallel.model_axis import whole_map

MIT_PRESETS = {
    # embed_dims, depths
    "b0": ((32, 64, 160, 256), (2, 2, 2, 2)),
    "b1": ((64, 128, 320, 512), (2, 2, 2, 2)),
    "b2": ((64, 128, 320, 512), (3, 4, 6, 3)),
    "b3": ((64, 128, 320, 512), (3, 4, 18, 3)),
    "b4": ((64, 128, 320, 512), (3, 8, 27, 3)),
    "b5": ((64, 128, 320, 512), (3, 6, 40, 3)),
}
MIT_HEADS = (1, 2, 5, 8)
MIT_SR = (8, 4, 2, 1)
MIT_MLP_RATIO = (4, 4, 4, 4)


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = FastVarianceLayerNorm(dim, eps=1e-5)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        h, w = hw
        nh = self.num_heads
        q = self.q(x).reshape(b, n, nh, c // nh)
        # on a band of the rows each rank reduces the windows of its own
        # output rows (a band starts on a whole stride-32 row; where the
        # level's height is not a multiple of r, "SAME" pads it on top too
        # and a window straddles the band edge: the 94 rows of stride 4 at
        # 376 pad 1 + 1, and `Conv2d` fetches the rows it reads), then the
        # keys and values come from the whole reduced map
        kv_in = x.reshape(b, h, w, c)
        if self.sr_ratio > 1:
            kv_in = self.sr(kv_in)
        kv_in = whole_map(kv_in).reshape(b, -1, c)
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(kv_in)
        kv = self.kv(kv_in).reshape(b, -1, 2, nh, c // nh)
        k, v = kv[:, :, 0], kv[:, :, 1]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (c // nh) ** -0.5
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return self.proj(out)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = Conv2d(hidden, hidden, 3, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        b, n, _ = x.shape
        h, w = hw
        y = self.fc1(x).reshape(b, h, w, self.hidden)
        y = self.dwconv(y).reshape(b, n, self.hidden)
        return self.fc2(F.gelu(y, approximate="none"))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = FastVarianceLayerNorm(dim, eps=1e-6)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = FastVarianceLayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


class MixVisionTransformer(nn.Module):
    """Returns the four stage outputs (strides 4, 8, 16, 32), NHWC; their
    widths are `out_channels`."""

    def __init__(self, preset: str = "b0"):
        super().__init__()
        dims, depths = MIT_PRESETS[preset]
        self.out_channels = tuple(dims)
        self.depths = depths
        in_ch = 3
        for s in range(4):
            k, stride = (7, 4) if s == 0 else (3, 2)
            self.add_module(f"patch_embed{s}", Conv2d(in_ch, dims[s], k, stride=stride))
            self.add_module(f"embed_norm{s}", FastVarianceLayerNorm(dims[s], eps=1e-6))
            for blk in range(depths[s]):
                self.add_module(f"stage{s}_block{blk}", MiTBlock(
                    dims[s], MIT_HEADS[s], MIT_SR[s], MIT_MLP_RATIO[s]))
            self.add_module(f"out_norm{s}", FastVarianceLayerNorm(dims[s], eps=1e-6))
            in_ch = dims[s]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """`generator` is ignored: MiT has no stochastic depth."""
        outs = []
        for s in range(4):
            x = getattr(self, f"patch_embed{s}")(x)
            b, h, w, c = x.shape
            x = getattr(self, f"embed_norm{s}")(x.reshape(b, h * w, c))
            for blk in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{blk}")(x, (h, w))
            x = getattr(self, f"out_norm{s}")(x).reshape(b, h, w, c)
            outs.append(x)
        return outs
