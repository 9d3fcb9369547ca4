"""Video K-Net for VPS: the online test step and its decode.

Counterpart of `video_knet_tpu/models/video/knet_vps.py` (`TrackEmbed`,
`VideoKNet.extract_feat` / `run_branch` / `test_step`, `vps_decode`).
Inference only: the joint training forward is not part of this slice.

Per frame the carried state is the previous frame's final kernels. Linking
is always computed (against zeros on a first frame) and `is_first` selects
the unlinked kernels for tracking, as the reference does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.config import VideoKNetConfig
from video_knet_tpu_torch.models.backbones import build_backbone, build_neck
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead, RPNOutputs
from video_knet_tpu_torch.models.kernel_iter_head import StageOutput, upscale_masks
from video_knet_tpu_torch.models.kernel_update_head import KernelUpdateHead
from video_knet_tpu_torch.models.knet import (
    PanopticPrediction,
    panoptic_decode,
    panoptic_decode_batch,
)
from video_knet_tpu_torch.models.layers import init_parameters
from video_knet_tpu_torch.utils.device import resolve_device


class BranchOutput(NamedTuple):
    rpn_out: RPNOutputs
    stage_outs: list[StageOutput]
    obj_feats_track: torch.Tensor | None  # [B, N_tot, K*K, C] linked kernels


class TrackEmbed(nn.Module):
    """embed_fcs (Linear no-bias -> LN -> ReLU) + fc_embed, then the track-head
    MLP (num_fcs x Linear-ReLU -> track_fc_embed)."""

    def __init__(self, in_channels: int = 256, channels: int = 256, num_fcs: int = 2):
        super().__init__()
        self.num_fcs = num_fcs
        self.embed_fc0 = nn.Linear(in_channels, channels, bias=False)
        self.embed_ln0 = nn.LayerNorm(channels, eps=1e-5)
        self.fc_embed = nn.Linear(channels, channels)
        for i in range(num_fcs):
            self.add_module(f"track_fc{i}", nn.Linear(channels, channels))
        self.track_fc_embed = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc_embed(F.relu(self.embed_ln0(self.embed_fc0(x))))
        for i in range(self.num_fcs):
            y = F.relu(getattr(self, f"track_fc{i}")(y))
        return self.track_fc_embed(y)


class VideoKNet(nn.Module):
    """The VPS model. Weights come from a seeded `generator` (flax's default
    initializers) or, after construction, from `utils/convert.py`.

    `device` defaults to CUDA and raises when there is none; tests pass
    `device="cpu"`."""

    def __init__(self, cfg: VideoKNetConfig, *, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        if cfg.track_head_type != "kernel_embed":
            raise NotImplementedError(
                f"track_head_type={cfg.track_head_type!r} is not ported yet (ROADMAP E3)")
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone)
        self.neck = build_neck(cfg.neck_type, self.backbone)
        self.rpn_head = ConvKernelHead(cfg.rpn, in_channels=self.neck.out_channels)
        self.num_stages = cfg.num_stages
        for s in range(cfg.num_stages):
            self.add_module(f"mask_head_{s}", KernelUpdateHead(
                cfg.head,
                with_previous=cfg.link_previous and s == cfg.num_stages - 1,
                previous_type=cfg.previous_type,
                previous_link=cfg.previous_link,
            ))
        self.track_embed = TrackEmbed(cfg.track.in_channels, cfg.track.embed_channels,
                                      cfg.track.num_fcs)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.eval()
        self.to(device)

    @property
    def heads(self) -> list[KernelUpdateHead]:
        return [getattr(self, f"mask_head_{s}") for s in range(self.num_stages)]

    def extract_feat(self, img: torch.Tensor) -> list[torch.Tensor]:
        return self.neck(self.backbone(img))

    def _stages(self, rpn_out: RPNOutputs, previous_obj_feats: torch.Tensor | None):
        outs = []
        object_feats = rpn_out.proposal_feats
        mask_preds = rpn_out.mask_preds
        obj_track = None
        for s, head in enumerate(self.heads):
            prev = previous_obj_feats if s == self.num_stages - 1 else None
            cls_score, mask_preds, object_feats, track = head(
                rpn_out.x_feats, object_feats, mask_preds, previous_obj_feats=prev)
            scaled = upscale_masks(mask_preds, self.cfg.head.mask_upsample_stride)
            outs.append(StageOutput(cls_score, mask_preds, scaled, object_feats))
            if track is not None:
                obj_track = track
        return outs, obj_track

    def run_branch(self, img: torch.Tensor,
                   previous_obj_feats: torch.Tensor | None = None) -> BranchOutput:
        """Full K-Net on one frame; linking at the last stage when previous given."""
        rpn_out = self.rpn_head(self.extract_feat(img))
        outs, obj_track = self._stages(rpn_out, previous_obj_feats)
        return BranchOutput(rpn_out, outs, obj_track)

    def embed(self, kernels: torch.Tensor) -> torch.Tensor:
        """Track embeddings from kernel vectors [..., K*K, C] (tap 0)."""
        return self.track_embed(kernels[..., 0, :])

    def test_step(self, img: torch.Tensor, prev_obj_feats: torch.Tensor,
                  is_first: bool | torch.Tensor) -> dict[str, Any]:
        """One online step. img [B, H, W, 3]; prev_obj_feats [B, N_tot, K*K, C].

        `is_first` is a bool, a 0-d bool tensor, or a [B] vector (multi-stream:
        first-frame rows also zero their carried kernels)."""
        cfg = self.cfg
        isf = is_first
        if torch.is_tensor(isf) and isf.dim() == 1:
            isf = isf[:, None, None, None]
            prev_obj_feats = torch.where(isf, torch.zeros_like(prev_obj_feats), prev_obj_feats)
        key = self.run_branch(img, prev_obj_feats if cfg.link_previous else None)
        last = key.stage_outs[-1]
        if key.obj_feats_track is None:
            track_src = last.object_feats
        elif torch.is_tensor(isf):
            track_src = torch.where(isf, last.object_feats, key.obj_feats_track)
        else:
            track_src = last.object_feats if isf else key.obj_feats_track
        embeds = self.embed(track_src[:, : cfg.num_proposals])
        return dict(
            rpn_out=key.rpn_out,
            stage_outs=key.stage_outs,
            track_obj_feats=track_src,
            track_embeds=embeds,
            new_obj_feats=last.object_feats,
        )


def vps_decode(rpn_out: RPNOutputs, stage_outs: list[StageOutput],
               track_obj_feats: torch.Tensor, cfg: VideoKNetConfig,
               out_hw: tuple[int, int] | None, batched: bool = False) -> PanopticPrediction:
    """Panoptic decode with the linked kernels as the thing-track handles.

    batched=True decodes every image of the batch (multi-stream serving)."""
    last = stage_outs[-1]
    patched = [*stage_outs[:-1], StageOutput(
        last.cls_score, last.mask_preds, last.scaled_mask_preds, track_obj_feats)]
    fn = panoptic_decode_batch if batched else panoptic_decode
    return fn(rpn_out, patched, cfg, out_hw=out_hw)
