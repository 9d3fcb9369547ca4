"""The MSDeformAttn pixel decoder: the neck of the deformable presets.

Counterpart of `video_knet_tpu/models/msdeform_decoder.py`
(`MSDeformAttention`, `DeformAttnEncoderLayer`, `_unflatten`,
`_reference_points`, `MSDeformAttnPixelDecoder`), with flax's module names.
It takes the backbone's raw levels (R-50: 256/512/1024/2048 wide, strides 4
to 32) and replaces the FPN: `input_proj{i}` projects the top three levels
to `embed_dim`, each gains the 2-D sine encoding and a learned
`level_embed{i}`, a stack of deformable-attention encoder layers runs over
all their tokens at once, and a top-down fusion (`lateral{i}`, nearest
upsampling, a GN `ConvNormAct` `fuse{i}`) rebuilds the lower levels. The
sampling is `ops/sampling.py:ms_deform_attn_core` (plain PyTorch gathers).

The encoder's LayerNorms are flax's `nn.LayerNorm` (one-pass variance);
the port runs torch's two-pass `nn.LayerNorm`, as its heads do (ROADMAP
3.3): equal within fp32 rounding while |mean| stays within a few standard
deviations of the tokens.

Under the band split of the mesh's `model` axis (`parallel/model_axis.py`)
the decoder runs on this rank's band of each level: the queries are the
band's tokens, with the whole level's positional code and reference points
at the band's global rows; every query may sample anywhere, so each
encoder layer projects the band's value maps and gathers them whole, the
three levels in one call (`model_axis.whole_maps`; its backward keeps this
rank's rows of the summed gradient). The top-down fusion's convolutions,
resize and GroupNorm take the band as they do in the FPN.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import (
    Conv2d,
    ConvNormAct,
    band_positional_encoding,
    resize_nearest,
)
from video_knet_tpu_torch.ops.sampling import ms_deform_attn_core
from video_knet_tpu_torch.parallel.model_axis import level_rows, token_share, whole_maps


class MSDeformAttention(nn.Module):
    """One multi-scale deformable attention over L levels: per-level value
    projections, `num_points` sampling offsets and attention weights a
    (head, level) from each query. `sampling_offsets` starts at zero, as
    flax initializes it."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        for i in range(num_levels):
            self.add_module(f"value_proj{i}", nn.Linear(embed_dim, embed_dim))
        self.sampling_offsets = nn.Linear(embed_dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(embed_dim, num_heads * num_levels * num_points)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.sampling_offsets.weight.zero_()

    def sampling_inputs(self, query: torch.Tensor, ref_points: torch.Tensor,
                        value_levels: list[torch.Tensor]):
        """What `ms_deform_attn_core` takes: the per-head values of each
        level, the sampling locations (the reference points moved by the
        offsets over each level's (w, h)) and the attention weights,
        softmaxed over L*P. On a band, `value_levels` are the band's maps:
        their projections are gathered whole."""
        b, q, c = query.shape
        m, l, p = self.num_heads, len(value_levels), self.num_points
        values = whole_maps([getattr(self, f"value_proj{i}")(v)
                             for i, v in enumerate(value_levels)])
        values = [v.reshape(b, *v.shape[1:3], m, c // m) for v in values]
        offsets = self.sampling_offsets(query).reshape(b, q, m, l, p, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(b, q, m, l * p), dim=-1)
        wh = _level_sizes(tuple((v.shape[2], v.shape[1]) for v in values), query.device)
        locs = ref_points[:, :, None, :, None, :] + offsets / wh[None, None, None, :, None, :]
        return values, locs, attn.reshape(b, q, m, l, p)

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor,
                value_levels: list[torch.Tensor]) -> torch.Tensor:
        """query [B, Q, C]; ref_points [B, Q, L, 2] normalized (x, y);
        value_levels L tensors [B, H_l, W_l, C] (on a band: the band's) ->
        [B, Q, C]."""
        return self.output_proj(ms_deform_attn_core(
            *self.sampling_inputs(query, ref_points, value_levels)))


class DeformAttnEncoderLayer(nn.Module):
    """Deformable self-attention over the flattened levels, then the FFN,
    each followed by its residual LayerNorm."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, ffn_dim: int = 1024,
                 num_levels: int = 3):
        super().__init__()
        self.self_attn = MSDeformAttention(embed_dim, num_heads, num_levels)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.ffn1 = nn.Linear(embed_dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor,
                shapes: list[tuple[int, int]]) -> torch.Tensor:
        att = self.self_attn(query, ref_points, _unflatten(query, shapes))
        query = self.norm1(query + att)
        y = self.ffn2(F.relu(self.ffn1(query)))
        return self.norm2(query + y)


@functools.lru_cache(maxsize=64)
def _level_sizes(wh: tuple[tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    """[L, 2] (w, h) of the levels, made once a shape set and device: a
    fresh host-to-device copy every call would wait on the host."""
    return torch.tensor(wh, dtype=torch.float32, device=device)


def _unflatten(flat: torch.Tensor, shapes: list[tuple[int, int]]) -> list[torch.Tensor]:
    """[B, sum HW, C] tokens -> one [B, H, W, C] map a level."""
    b, _, c = flat.shape
    sizes = [h * w for h, w in shapes]
    return [x.reshape(b, h, w, c) for x, (h, w) in zip(flat.split(sizes, dim=1), shapes)]


def _reference_points(shapes: list[tuple[int, int]], device=None) -> torch.Tensor:
    """Every level's pixel centres, normalized (x, y) -> [sum HW, 2]. On a
    band, `shapes` are the band's levels: their rows' centres over the
    whole level's height (`model_axis.level_rows`)."""
    pts = []
    for h, w in shapes:
        first, end, height = level_rows(h, w)
        ys = (torch.arange(first, end, dtype=torch.float32, device=device) + 0.5) / height
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return torch.cat(pts, dim=0)


class MSDeformAttnPixelDecoder(nn.Module):
    """Encoder over the top `num_encoder_levels` backbone levels, then the
    top-down fusion into the lower ones. `in_channels` are the backbone's
    level widths; every output level is `embed_dim` wide (`out_channels`)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), embed_dim: int = 256,
                 num_layers: int = 6, num_encoder_levels: int = 3):
        super().__init__()
        self.out_channels = embed_dim
        self.num_layers = num_layers
        self.num_encoder_levels = num_encoder_levels
        enc_in = in_channels[-num_encoder_levels:]
        self.num_lower = len(in_channels) - num_encoder_levels
        for i, c in enumerate(enc_in):
            self.add_module(f"input_proj{i}", Conv2d(c, embed_dim, 1))
            self.register_parameter(f"level_embed{i}", nn.Parameter(torch.empty(embed_dim)))
        for i in range(num_layers):
            self.add_module(f"layer{i}", DeformAttnEncoderLayer(
                embed_dim, num_levels=num_encoder_levels))
        for i in range(self.num_lower):
            self.add_module(f"lateral{i}", Conv2d(in_channels[i], embed_dim, 1))
            self.add_module(f"fuse{i}", ConvNormAct(embed_dim, embed_dim, 3))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        for i in range(self.num_encoder_levels):
            getattr(self, f"level_embed{i}").normal_(0.0, 1.0, generator=generator)

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        """feats: the backbone's levels (strides 4, 8, 16, 32), NHWC ->
        refreshed levels, each `embed_dim` wide; on a band, the band's of
        each."""
        enc_feats = feats[-self.num_encoder_levels:]
        shapes = [(f.shape[1], f.shape[2]) for f in enc_feats]
        b, c = feats[0].shape[0], self.out_channels
        tokens = []
        for i, f in enumerate(enc_feats):
            x = getattr(self, f"input_proj{i}")(f)
            pe = band_positional_encoding(x.shape[1], x.shape[2], c // 2, device=x.device)
            lvl = getattr(self, f"level_embed{i}")
            tokens.append((x + pe[None] + lvl[None, None, None]).reshape(b, -1, c))
        query = torch.cat(tokens, dim=1)

        ref = _reference_points(shapes, device=query.device)
        ref = ref[None, :, None, :].expand(b, ref.shape[0], len(shapes), 2)
        with token_share(shapes):
            for i in range(self.num_layers):
                query = getattr(self, f"layer{i}")(query, ref, shapes)

        outs = _unflatten(query, shapes)
        prev = outs[0]
        for i in range(self.num_lower - 1, -1, -1):
            lat = getattr(self, f"lateral{i}")(feats[i])
            up = resize_nearest(prev, tuple(lat.shape[1:3]), dims=(1, 2))
            prev = getattr(self, f"fuse{i}")(lat + up)
            outs.insert(0, prev)
        return outs
