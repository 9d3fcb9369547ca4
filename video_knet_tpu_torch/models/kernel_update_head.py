"""KernelUpdateHead: one stage of iterative kernel refinement, inference forward.

Counterpart of `video_knet_tpu/models/kernel_update_head.py`:
 1. mask-pool features with hard-thresholded sigmoid masks (CUDA kernel K1)
 2. KernelUpdator fuses pooled group features into the kernels
 3. multi-head self-attention over the kernel set + LN
 4. FFN + LN
 5. cls branch (MLP -> fc_cls) and mask branch (MLP -> fc_mask)
 6. new masks = dynamic conv of the kernels against the features
    (K=1: the contraction of CUDA kernel K2, no sigmoid)

The video variant (`with_previous`, `previous_type='ffn'`) adds the
cross-frame link that feeds the tracking embedding.
"""

from __future__ import annotations

import torch
from torch import nn

from video_knet_tpu_torch.config import KernelUpdateHeadConfig
from video_knet_tpu_torch.models.kernel_updator import KernelUpdator
from video_knet_tpu_torch.models.layers import (
    FFN,
    MLP,
    Conv2d,
    MultiHeadAttention,
    resize_mask_bilinear,
)
from video_knet_tpu_torch.ops.kernels.mask_ops import fused_assemble
from video_knet_tpu_torch.ops.mask_pool import mask_pool

FOCAL_PRIOR_BIAS = -4.59511985013459  # fc_cls bias init: prior 0.01


def assemble_masks(kernels: torch.Tensor, x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Dynamic conv of per-image kernels against features.

    kernels [B, N, K*K, C]; x [B, H, W, C] -> [B, N, H, W] logits."""
    if kernel_size != 1:
        raise NotImplementedError(
            "conv_kernel_size > 1 (grouped dynamic conv) is not ported yet (ROADMAP E4)")
    return fused_assemble(kernels[:, :, 0, :].contiguous(), x.contiguous())


class KernelUpdateHead(nn.Module):
    def __init__(self, cfg: KernelUpdateHeadConfig, with_previous: bool = False,
                 previous_type: str = "ffn", previous_link: str | None = None):
        super().__init__()
        if previous_link is not None:
            raise NotImplementedError(
                f"previous_link={previous_link!r} is not ported yet (ROADMAP E4)")
        if with_previous and previous_type != "ffn":
            raise NotImplementedError(
                f"previous_type={previous_type!r} is not ported yet (ROADMAP E4)")
        if cfg.conv_kernel_size != 1:
            raise NotImplementedError(
                "conv_kernel_size > 1 (grouped dynamic conv) is not ported yet (ROADMAP E4)")
        self.cfg = cfg
        self.with_previous = with_previous
        c = cfg.in_channels
        if cfg.feat_transform:
            self.feat_transform = Conv2d(c, c, 1)
        u = cfg.updator
        self.kernel_update_conv = KernelUpdator(u.in_channels, u.feat_channels, u.out_channels)
        self.attention = MultiHeadAttention(c, cfg.num_heads)
        self.attention_norm = nn.LayerNorm(c, eps=1e-5)
        if cfg.with_ffn:
            self.ffn = FFN(c, cfg.feedforward_channels, c)
            self.ffn_norm = nn.LayerNorm(c, eps=1e-5)
        if with_previous:
            self.attention_previous = MultiHeadAttention(c, cfg.num_heads)
            self.attention_previous_norm = nn.LayerNorm(c, eps=1e-5)
            self.link_ffn_previous = FFN(c, cfg.feedforward_channels, c)
            self.link_ffn_previous_norm = nn.LayerNorm(c, eps=1e-5)
        self.cls_fcs = MLP(cfg.num_cls_fcs, c, c)
        self.mask_fcs = MLP(cfg.num_mask_fcs, c, c)
        self.fc_cls = nn.Linear(c, cfg.num_classes)
        self.fc_mask = nn.Linear(c, cfg.out_channels)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.fc_cls.bias.fill_(FOCAL_PRIOR_BIAS)

    def forward(self, x: torch.Tensor, proposal_feat: torch.Tensor, mask_preds: torch.Tensor,
                previous_obj_feats: torch.Tensor | None = None):
        """x [B, H, W, C]; proposal_feat [B, N, K*K, C]; mask_preds [B, N, Hm, Wm].

        Returns (cls_score [B, N, num_classes], new_mask_preds [B, N, H, W],
        obj_feat [B, N, K*K, C], obj_feat_track or None)."""
        cfg = self.cfg
        b, n = proposal_feat.shape[:2]
        if cfg.feat_transform:
            x = self.feat_transform(x)
        h, w, c = x.shape[1:]
        gather_mask = resize_mask_bilinear(mask_preds, (h, w))
        x_feat = mask_pool(gather_mask, x, hard_thr=cfg.hard_mask_thr, binary=True)

        obj_feat = self.kernel_update_conv(x_feat, proposal_feat)
        g = obj_feat.shape[2]
        flat = obj_feat.reshape(b, n, g * c)
        flat = self.attention_norm(flat + self.attention(flat, flat))
        obj_feat = flat.reshape(b, n, g, c)
        if cfg.with_ffn:
            obj_feat = self.ffn_norm(self.ffn(obj_feat))

        obj_feat_track = None
        if self.with_previous and previous_obj_feats is not None:
            # cross-attn(query=cur, kv=prev) + LN + link FFN + LN
            prev = previous_obj_feats.reshape(b, n, g * c)
            cur = obj_feat.reshape(b, n, g * c)
            y = self.attention_previous_norm(cur + self.attention_previous(cur, prev))
            obj_feat_track = self.link_ffn_previous_norm(
                self.link_ffn_previous(y.reshape(b, n, g, c)))

        cls_feat = self.cls_fcs(obj_feat.sum(dim=-2))
        mask_feat = self.mask_fcs(obj_feat)
        cls_score = self.fc_cls(cls_feat)
        mask_kernels = self.fc_mask(mask_feat)
        new_mask_preds = assemble_masks(mask_kernels, x, cfg.conv_kernel_size)
        return cls_score, new_mask_preds, obj_feat, obj_feat_track
