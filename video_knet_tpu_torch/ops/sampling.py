"""Gather-based bilinear sampling, RoIAlign and the multi-scale deformable
attention core.

Counterpart of `video_knet_tpu/ops/sampling.py` (`bilinear_sample`, and
`bilinear_sample_batch` for its vmap over a batch, `roi_align`,
`ms_deform_attn_core`): the four corner gathers with zero padding outside
the map, in the reference's arithmetic order (`x * w - 0.5` in fp32, the
top and bottom lerps, then the vertical one). The reference clips the
indices and multiplies by the validity mask; torch indexing raises on an
index out of range, so the indices are clamped explicitly before the
gather. Plain PyTorch on every device: the reference computes this outside
any Pallas kernel.

`ms_deform_attn_core` reduces level by level: one level's samples
[B, Q, M, P, D] are weighted and summed before the next level is gathered,
so the [B, Q, M, L, P, D] stack the reference builds never exists (one
corner of it is ~270 MB at COCO's 800x1344). The sum over (level, point)
therefore runs in another order than the reference's einsum: equal within
fp32 rounding.
"""

from __future__ import annotations

import torch


def bilinear_sample(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample feat [H, W, C] at float pixel coordinates ys / xs [...], zero
    outside the map -> [..., C]."""
    h, w, c = feat.shape
    return _bilinear_flat(feat.reshape(h * w, c), h, w, ys, xs, None)


def bilinear_sample_batch(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """`bilinear_sample` of each image of a batch (the reference vmaps it):
    feat [B, H, W, C], ys / xs [B, ...] -> [B, ..., C]."""
    b, h, w, c = feat.shape
    base = (torch.arange(b, device=feat.device) * (h * w)).reshape(b, *(1,) * (ys.dim() - 1))
    return _bilinear_flat(feat.reshape(b * h * w, c), h, w, ys, xs, base)


def _bilinear_flat(flat: torch.Tensor, h: int, w: int, ys: torch.Tensor, xs: torch.Tensor,
                   base: torch.Tensor | None) -> torch.Tensor:
    """`flat` [..., H*W rows, C] as rows; `base` (broadcast with ys) is the
    row offset of each sample's own map in `flat`, None for one map."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = yc * w + xc
        if base is not None:
            idx = idx + base
        return flat[idx] * valid[..., None]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def roi_align(feat: torch.Tensor, rois: torch.Tensor, *, out_size: int = 7,
              sampling_ratio: int = 2, spatial_scale: float = 1.0,
              aligned: bool = True) -> torch.Tensor:
    """RoIAlign over one image, mmcv's `RoIAlign(aligned=True)`: feat
    [H, W, C], rois [R, 4] xyxy in image coordinates -> [R, out, out, C].

    Each output bin averages sampling_ratio^2 bilinear samples at regular
    sub-bin positions. A sample outside [-1, H] x [-1, W] gives 0; one inside
    that window is clamped to the map's edges (the border pixel's value, not
    zero padding). Box sizes are floored at 1e-6. Autograd flows to `feat`
    through the gathers."""
    offset = 0.5 if aligned else 0.0
    boxes = rois * spatial_scale - offset  # [R, 4]
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bh = torch.clamp(y1 - y0, min=1e-6)[:, None, None, None]
    bw = torch.clamp(x1 - x0, min=1e-6)[:, None, None, None]
    s = sampling_ratio
    dev = feat.device
    bin_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    sub_idx = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    grid = (bin_idx[:, None] + sub_idx[None, :]) / out_size  # [out, s]
    gy = grid.reshape(1, out_size, s, 1, 1)
    gx = grid.reshape(1, 1, 1, out_size, s)
    shape = (rois.shape[0], out_size, s, out_size, s)
    ys = (y0[:, None, None, None, None] + bh[..., None] * gy).expand(shape)
    xs = (x0[:, None, None, None, None] + bw[..., None] * gx).expand(shape)
    h, w, _ = feat.shape
    valid = (ys >= -1.0) & (ys <= h) & (xs >= -1.0) & (xs <= w)
    samples = bilinear_sample(feat, ys.clamp(0.0, h - 1.0), xs.clamp(0.0, w - 1.0))
    return (samples * valid[..., None]).mean(dim=(2, 4))


def ms_deform_attn_core(value_levels: list[torch.Tensor], sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """value_levels: L tensors [B, H_l, W_l, M, D] (the values split by head);
    sampling_locations [B, Q, M, L, P, 2] normalized (x, y); attention_weights
    [B, Q, M, L, P] (softmaxed over L*P) -> [B, Q, M*D]."""
    b, q, m, _, p, _ = sampling_locations.shape
    out = None
    for li, v in enumerate(value_levels):
        h, w, d = v.shape[1], v.shape[2], v.shape[-1]
        loc = sampling_locations[:, :, :, li]  # [B, Q, M, P, 2]
        xs = loc[..., 0] * w - 0.5
        ys = loc[..., 1] * h - 0.5
        # rows of (batch, head) planes: plane (b, m) starts at row (b*M + m)*H*W
        flat = v.permute(0, 3, 1, 2, 4).reshape(b * m * h * w, d)
        base = (torch.arange(b, device=v.device)[:, None, None, None] * m
                + torch.arange(m, device=v.device)[None, None, :, None]) * (h * w)
        sampled = _bilinear_flat(flat, h, w, ys, xs, base)  # [B, Q, M, P, D]
        part = (sampled * attention_weights[:, :, :, li, :, None]).sum(dim=3)
        out = part if out is None else out + part
    return out.reshape(b, q, -1)
