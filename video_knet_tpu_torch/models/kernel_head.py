"""ConvKernelHead: the kernel-init ("RPN") head, inference forward.

Counterpart of `video_knet_tpu/models/kernel_head.py`. The localization
FPN is the Semantic-FPN or, with `fpn_type='upernet_align'`, the SFNet
aligned head (`models/sfnet.py`). The init-mask contraction runs the CUDA
kernel K2 (no sigmoid) and the proposal pooling runs K1 on the card.

Under the frame split of the mesh's `model` axis the head runs on this
rank's frames, every op per frame (the temporal positional encoding the
whole clip's rows of them). On a band of the image rows (the band split)
the head runs on the band's pyramid: the Semantic-FPN and the 1x1 convs on
its rows, K2's init masks and the stuff logits on the band, K1's pooled
features summed over the `model` group (`ops/mask_pool.py`). The aligned
head, whose flow warps reach anywhere in the map, runs on the gathered
pyramid instead, and its outputs are cut to the band.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from video_knet_tpu_torch.config import ConvKernelHeadConfig
from video_knet_tpu_torch.models.layers import Conv2d, ConvNormAct
from video_knet_tpu_torch.models.semantic_fpn import SemanticFPN
from video_knet_tpu_torch.models.sfnet import UperNetAlignHead
from video_knet_tpu_torch.ops.kernels.mask_ops import fused_assemble
from video_knet_tpu_torch.ops.mask_pool import mask_pool
from video_knet_tpu_torch.parallel.model_axis import (
    band_slice,
    held_share,
    in_band,
    off_band,
    whole_map,
)


class RPNOutputs(NamedTuple):
    proposal_feats: torch.Tensor  # [B, N_total, K*K, C] init kernels (things + stuff)
    x_feats: torch.Tensor  # [B, H, W, C] fused features for the iter head
    mask_preds: torch.Tensor  # [B, N_total, H, W] init mask logits
    seg_preds: torch.Tensor  # [B, H, W, num_classes] semantic logits
    thing_mask_preds: torch.Tensor  # [B, N_prop, H, W]
    init_kernels: torch.Tensor  # [N_prop, C]


class ConvKernelHead(nn.Module):
    """`in_channels` is the neck's output width: the JAX head infers its
    localization FPN's input width from the features and never reads
    `cfg.in_channels`."""

    def __init__(self, cfg: ConvKernelHeadConfig, in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        if cfg.fpn_type == "upernet_align":
            self.localization_fpn = UperNetAlignHead(
                in_channels=in_channels,
                out_channels=cfg.out_channels,
                num_aux_convs=max(cfg.fpn_num_aux_convs, 1),
                with_positional_encoding=cfg.fpn_positional_encoding,
            )
        else:
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

    def forward(self, feats: list[torch.Tensor], num_frames: int | None = None) -> RPNOutputs:
        """`num_frames` set: clip inputs [B*T, ...], and the localization FPN
        takes the temporal positional encoding (the aligned head has none,
        and raises ValueError, as the reference does)."""
        cfg = self.cfg
        if cfg.fpn_type == "upernet_align" and in_band() is not None:
            whole = [whole_map(f) for f in feats]
            with off_band():
                out = self(whole, num_frames)
            return out._replace(**{k: band_slice(getattr(out, k), d) for k, d in (
                ("x_feats", 1), ("mask_preds", 2), ("seg_preds", 1), ("thing_mask_preds", 2))})
        with held_share():  # a ReLU decision replayed on a band or frames is cut to it
            loc_feats, semantic_feats = self.localization_fpn(feats, num_frames)[:2]
            for i in range(cfg.num_loc_convs):
                loc_feats = getattr(self, f"loc_conv{i}")(loc_feats)
            for i in range(cfg.num_seg_convs):
                semantic_feats = getattr(self, f"seg_conv{i}")(semantic_feats)

        b = loc_feats.shape[0]
        loc_feats = loc_feats.contiguous()
        kernels = self.init_kernels[None].expand(b, -1, -1).contiguous()
        # [B, N, H, W], in the inputs' dtype as JAX's einsum gives it (bf16 training)
        mask_preds = fused_assemble(kernels, loc_feats).to(
            torch.promote_types(kernels.dtype, loc_feats.dtype))

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
