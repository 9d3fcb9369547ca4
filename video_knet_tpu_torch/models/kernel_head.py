"""ConvKernelHead: the kernel-init ("RPN") head, inference forward.

Counterpart of `video_knet_tpu/models/kernel_head.py`. The init-mask
contraction runs the CUDA kernel K2 (no sigmoid) and the proposal pooling
runs K1 on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from video_knet_tpu_torch.config import ConvKernelHeadConfig
from video_knet_tpu_torch.models.layers import Conv2d, ConvNormAct
from video_knet_tpu_torch.models.semantic_fpn import SemanticFPN
from video_knet_tpu_torch.ops.kernels.mask_ops import fused_assemble
from video_knet_tpu_torch.ops.mask_pool import mask_pool


class RPNOutputs(NamedTuple):
    proposal_feats: torch.Tensor  # [B, N_total, K*K, C] init kernels (things + stuff)
    x_feats: torch.Tensor  # [B, H, W, C] fused features for the iter head
    mask_preds: torch.Tensor  # [B, N_total, H, W] init mask logits
    seg_preds: torch.Tensor  # [B, H, W, num_classes] semantic logits
    thing_mask_preds: torch.Tensor  # [B, N_prop, H, W]
    init_kernels: torch.Tensor  # [N_prop, C]


class ConvKernelHead(nn.Module):
    def __init__(self, cfg: ConvKernelHeadConfig):
        super().__init__()
        if cfg.fpn_type != "semantic_fpn":
            raise NotImplementedError(
                f"fpn_type={cfg.fpn_type!r} is not ported yet (ROADMAP E2)")
        self.cfg = cfg
        self.localization_fpn = SemanticFPN(
            in_channels=cfg.in_channels,
            feat_channels=cfg.fpn_feat_channels,
            out_channels=cfg.out_channels,
            upsample_times=cfg.fpn_upsample_times,
            with_positional_encoding=cfg.fpn_positional_encoding,
            num_aux_convs=cfg.fpn_num_aux_convs,
        )
        for i in range(cfg.num_loc_convs):
            self.add_module(f"loc_conv{i}", ConvNormAct(cfg.out_channels, cfg.out_channels, 1))
        for i in range(cfg.num_seg_convs):
            self.add_module(f"seg_conv{i}", ConvNormAct(cfg.out_channels, cfg.out_channels, 1))
        self.init_kernels = nn.Parameter(torch.empty(cfg.num_proposals, cfg.out_channels))
        self.conv_seg = Conv2d(cfg.out_channels, cfg.num_classes, 1)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.init_kernels.normal_(0.0, self.cfg.kernel_init_std, generator=generator)

    def forward(self, feats: list[torch.Tensor]) -> RPNOutputs:
        cfg = self.cfg
        loc_feats, semantic_feats = self.localization_fpn(feats)[:2]
        for i in range(cfg.num_loc_convs):
            loc_feats = getattr(self, f"loc_conv{i}")(loc_feats)
        for i in range(cfg.num_seg_convs):
            semantic_feats = getattr(self, f"seg_conv{i}")(semantic_feats)

        b = loc_feats.shape[0]
        loc_feats = loc_feats.contiguous()
        kernels = self.init_kernels[None].expand(b, -1, -1).contiguous()
        mask_preds = fused_assemble(kernels, loc_feats)  # [B, N, H, W]

        seg_preds = self.conv_seg(semantic_feats)  # [B, H, W, num_classes]
        x_feats = (semantic_feats + loc_feats).contiguous()

        proposal_feats = self.init_kernels[None].expand(b, -1, -1)
        if cfg.proposal_feats_with_obj:
            # the init head thresholds at 0.5 regardless of the stage config
            obj_feats = mask_pool(mask_preds, x_feats, hard_thr=0.5, binary=cfg.use_binary)
            proposal_feats = proposal_feats + obj_feats

        thing_mask_preds = mask_preds
        if cfg.cat_stuff_mask:
            nt = cfg.num_thing_classes
            stuff_logits = seg_preds[..., nt:].permute(0, 3, 1, 2)
            mask_preds = torch.cat([mask_preds, stuff_logits], dim=1).contiguous()
            # stuff kernels are the conv_seg weights of the stuff classes
            stuff_kernels = self.conv_seg.weight[nt:, :, 0, 0]  # [S, C]
            proposal_feats = torch.cat(
                [proposal_feats, stuff_kernels[None].expand(b, -1, -1)], dim=1)

        return RPNOutputs(
            proposal_feats=proposal_feats[:, :, None, :],
            x_feats=x_feats,
            mask_preds=mask_preds,
            seg_preds=seg_preds,
            thing_mask_preds=thing_mask_preds,
            init_kernels=self.init_kernels,
        )
