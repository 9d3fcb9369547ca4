"""RoIAlign track-embedding head (the RoI / GT-box ablation,
`track_head_type='roi_gt_box'`).

Counterpart of `video_knet_tpu/models/video/roi_track_head.py`: instead of
embedding the refined kernels, features are RoIAligned from the fused
feature map at mask-derived boxes (GT masks at train time, one box per GT
slot; the predicted masks' sigmoid at test time), passed through 4 x (3x3
conv + GroupNorm(32) + ReLU), averaged over the 7x7 bins, then fc + ReLU
and `fc_embed`. Submodules carry flax's names (`conv{i}`, `gn{i}`, `fc{i}`,
`fc_embed`), so `utils/convert.py` maps the reference's variables
unchanged.

The reference applies flax's GroupNorm to the [B, G, 7, 7, C] stack of an
image's RoIs: its statistics pool every RoI of the image (flax reduces over
all axes but the first and the channels), with the one-pass variance
(`use_fast_variance=True`, flax's default). `RoIGroupNorm` does the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import Conv2d, GroupNorm
from video_knet_tpu_torch.ops.sampling import roi_align


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """[G, H, W] float masks -> [G, 4] xyxy boxes of the pixels above 0.5
    (zeros for empty masks), on the masks' device."""
    occ = masks > 0.5
    any_y = occ.any(dim=2)  # [G, H]
    any_x = occ.any(dim=1)  # [G, W]
    h, w = masks.shape[1:]
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    big = 1e9
    y0 = torch.where(any_y, ys[None], big).amin(dim=1)
    y1 = torch.where(any_y, ys[None], -big).amax(dim=1) + 1
    x0 = torch.where(any_x, xs[None], big).amin(dim=1)
    x1 = torch.where(any_x, xs[None], -big).amax(dim=1) + 1
    empty = ~occ.any(dim=(1, 2))
    boxes = torch.stack([x0, y0, x1, y1], dim=1)
    return torch.where(empty[:, None], 0.0, boxes)


class RoIGroupNorm(GroupNorm):
    """flax `nn.GroupNorm(num_groups, epsilon)` on a [B, ..., C] stack:
    statistics over every axis but the first and the channel groups, one-pass
    variance max(E[x^2] - E[x]^2, 0), the scale folded into the rsqrt."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = x.reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((g * g).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        size = c // self.num_groups
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.repeat_interleave(size, dim=-1).reshape(shape)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(size, dim=-1).reshape(shape)
        return (x - mean) * (mul * self.weight) + self.bias


class ROITrackHead(nn.Module):
    """RoIAlign(7x7) -> num_convs x (3x3 conv + GN + ReLU) -> bin mean ->
    num_fcs x (fc + ReLU) -> fc_embed."""

    def __init__(self, in_channels: int = 256, embed_channels: int = 256,
                 num_convs: int = 4, num_fcs: int = 1, roi_size: int = 7):
        super().__init__()
        self.num_convs, self.num_fcs, self.roi_size = num_convs, num_fcs, roi_size
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(in_channels if i == 0 else embed_channels,
                                               embed_channels, 3))
            self.add_module(f"gn{i}", RoIGroupNorm(embed_channels))
        for i in range(num_fcs):
            self.add_module(f"fc{i}", nn.Linear(embed_channels, embed_channels))
        self.fc_embed = nn.Linear(embed_channels, embed_channels)

    def forward(self, feats: torch.Tensor, boxes: torch.Tensor,
                spatial_scale: float) -> torch.Tensor:
        """feats [B, H, W, C]; boxes [B, G, 4] xyxy in mask coordinates ->
        [B, G, D]."""
        b, g = boxes.shape[:2]
        r = self.roi_size
        y = torch.stack([roi_align(f, bx, out_size=r, spatial_scale=spatial_scale)
                         for f, bx in zip(feats, boxes)])  # [B, G, r, r, C]
        for i in range(self.num_convs):
            y = getattr(self, f"conv{i}")(y.reshape(b * g, r, r, -1)).reshape(b, g, r, r, -1)
            y = F.relu(getattr(self, f"gn{i}")(y))
        y = y.mean(dim=(2, 3))
        for i in range(self.num_fcs):
            y = F.relu(getattr(self, f"fc{i}")(y))
        return self.fc_embed(y)


def roi_track_loss(key_embeds, ref_embeds, key_valid, ref_valid, key_ids, ref_ids, *,
                   loss_track_weight: float = 0.25,
                   aux_weight: float = 1.0) -> dict[str, torch.Tensor]:
    """MultiPosCE + L2 aux on GT-slot-aligned embeddings [B, G, D], image by
    image (the kernel-embedding head's `_track_loss_one`)."""
    from video_knet_tpu_torch.models.video.knet_vps import _track_loss_one
    from video_knet_tpu_torch.parallel.mesh import global_mean

    per_image = [_track_loss_one(
        key_embeds[i], ref_embeds[i], key_valid[i], ref_valid[i], key_ids[i], ref_ids[i],
        loss_track_weight=loss_track_weight, aux_weight=aux_weight, aux_neg_pos_ub=3,
        aux_neg_margin=0.1) for i in range(key_embeds.shape[0])]
    return {"loss_track_roi": global_mean(torch.stack([lt for lt, _ in per_image])),
            "loss_track_roi_aux": global_mean(torch.stack([la for _, la in per_image]))}
