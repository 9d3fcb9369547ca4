"""The volume (tube) kernel-init head of VIS clips.

Counterpart of `video_knet_tpu/models/vis/volume_head.py`
(`ClipVolumeKernelHead`): the learned init kernels convolve against the
whole clip's localization features at once, so one kernel owns one tube
[B, T, N, H, W] from the start; the kernels are then enriched with the
tube-mask-pooled clip features. On the card the tube masks are K2 over the
kernels expanded to [B*T, N, C], and the pooling is K1 over B*T at
threshold 0.5, then the sum over T divided by T.

Under the frame split of the mesh's `model` axis the head runs on this
rank's frames of each clip (K1 and K2 over B*T_r); the pooled sum over
them is summed over the `model` group and divided by the clip's length
(`parallel/model_axis.py:frame_sum`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from video_knet_tpu_torch.config import ConvKernelHeadConfig
from video_knet_tpu_torch.models.layers import Conv2d, ConvNormAct
from video_knet_tpu_torch.models.semantic_fpn import SemanticFPN
from video_knet_tpu_torch.models.vis.clip_head import clip_assemble, clip_mask_pool
from video_knet_tpu_torch.parallel.model_axis import frame_sum, held_share, local_frames


class VolumeRPNOutputs(NamedTuple):
    proposal_feats: torch.Tensor  # [B, N, C] clip (tube) kernels
    x_feats: torch.Tensor  # [B, T, H, W, C]
    tube_mask_preds: torch.Tensor  # [B, T, N, H, W]
    seg_preds: torch.Tensor  # [B, T, H, W, num_classes]


class ClipVolumeKernelHead(nn.Module):
    """`in_channels` is the neck's output width. The localization FPN is
    always the Semantic-FPN: the reference's volume head never reads
    `fpn_type`."""

    def __init__(self, cfg: ConvKernelHeadConfig, in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        self.localization_fpn = SemanticFPN(
            in_channels=in_channels,
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

    def forward(self, feats: list[torch.Tensor], num_frames: int) -> VolumeRPNOutputs:
        """feats: FPN levels with leading axis B*T (frames contiguous per
        video; under the frame split this rank's frames of each clip);
        `num_frames` the clip's length."""
        cfg = self.cfg
        with held_share():  # a ReLU decision replayed on frames is cut to them
            loc_feats, semantic_feats = self.localization_fpn(feats, num_frames)[:2]
            for i in range(cfg.num_loc_convs):
                loc_feats = getattr(self, f"loc_conv{i}")(loc_feats)
            for i in range(cfg.num_seg_convs):
                semantic_feats = getattr(self, f"seg_conv{i}")(semantic_feats)

        bt, h, w, c = loc_feats.shape
        t = local_frames(num_frames)
        b = bt // t
        # volume dynamic conv: one kernel -> one tube across all frames
        kernels = self.init_kernels[None].expand(b, -1, -1)
        tube_masks = clip_assemble(kernels, loc_feats.reshape(b, t, h, w, c))
        seg_preds = self.conv_seg(semantic_feats)
        x_feats = (semantic_feats + loc_feats).reshape(b, t, h, w, c)
        proposal_feats = kernels
        if cfg.proposal_feats_with_obj:
            obj = frame_sum(clip_mask_pool(tube_masks, x_feats, 0.5).sum(dim=1)) / num_frames
            proposal_feats = proposal_feats + obj
        return VolumeRPNOutputs(
            proposal_feats=proposal_feats,
            x_feats=x_feats,
            tube_mask_preds=tube_masks,
            seg_preds=seg_preds.reshape(b, t, h, w, -1),
        )
