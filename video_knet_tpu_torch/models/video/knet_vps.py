"""Video K-Net for VPS: the joint train forward and its losses, the online
test step and its decode.

Counterpart of `video_knet_tpu/models/video/knet_vps.py` (`TrackEmbed`,
`QueryTrackEmbed`, `VideoKNet.__call__` as `forward_train`, `extract_feat` /
`run_branch` / `test_step` / `_roi_embed`, `_track_loss_one`,
`_query_match_loss_one`, `video_knet_loss`, `vps_decode`), for every
`track_head_type`:

- `kernel_embed` (the release head): the final kernels are embedded by
  `TrackEmbed` and supervised with MultiPosCE and the L2 auxiliary loss on
  instance-id matches;
- `query_fuse` (the fuse-track ablation): `QueryTrackEmbed`'s 1024-wide
  query embeddings, supervised with the match-score cross entropy against
  the reference kernels (a leading "new object" column);
- `roi_gt_box` (the RoI / GT-box ablation): `roi_track_head.ROITrackHead`
  RoIAligns the fused features at GT-mask boxes (train, GT-slot aligned) or
  at the predicted masks' boxes (test).

Train: the key frame and one reference frame share one backbone, neck and
init-head pass over [ref; key]; the ref stages run plain, the key stages
link their last stage to the ref branch's final kernels (not detached).

Test: per frame the carried state is the previous frame's final kernels.
Linking is always computed (against zeros on a first frame) and `is_first`
selects the unlinked kernels for tracking, as the reference does.

Under the band split of the mesh's `model` axis (`parallel/model_axis.py`)
the train forward runs the heads on this rank's band of the image rows and
`video_knet_costs` / `video_knet_loss` take the GT's band
(`ops/targets.py:gt_band`); the kernel embeddings work on kernels only,
and the RoI / GT-box head, whose boxes reach anywhere in the map, RoIAligns
the whole fused map (`model_axis.whole_map`) at the whole GT's boxes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.config import VideoKNetConfig
from video_knet_tpu_torch.models.backbones import (
    backbone_and_neck,
    build_backbone,
    build_neck,
    pyramid_width,
)
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead, RPNOutputs
from video_knet_tpu_torch.models.kernel_iter_head import StageOutput, upscale_masks
from video_knet_tpu_torch.models.kernel_update_head import KernelUpdateHead
from video_knet_tpu_torch.models.knet import (
    PanopticPrediction,
    branch_assignment_costs,
    detached_cost,
    iter_head_losses,
    panoptic_decode,
    panoptic_decode_batch,
    rpn_loss,
    solve_lanes,
)
from video_knet_tpu_torch.models.layers import init_parameters
from video_knet_tpu_torch.models.video.roi_track_head import (
    ROITrackHead,
    masks_to_boxes,
    roi_track_loss,
)
from video_knet_tpu_torch.ops import losses as L
from video_knet_tpu_torch.ops.targets import PanopticGT, gather_rows
from video_knet_tpu_torch.parallel.mesh import batch_blocks, global_mean
from video_knet_tpu_torch.parallel.model_axis import off_band, whole_map
from video_knet_tpu_torch.utils.device import resolve_device
from video_knet_tpu_torch.utils.profiling import span


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


class QueryTrackEmbed(nn.Module):
    """The fuse-track head's per-kernel MLP: Linear(C) + ReLU, Linear(1024).
    The match score against the reference kernels has no parameters and
    lives in the loss (`_query_match_loss_one`) and the tracker."""

    def __init__(self, in_channels: int = 256, channels: int = 256, out_channels: int = 1024):
        super().__init__()
        self.fc0 = nn.Linear(in_channels, channels)
        self.fc1 = nn.Linear(channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(F.relu(self.fc0(x)))


class VideoKNet(nn.Module):
    """The VPS model. Weights come from a seeded `generator` (flax's default
    initializers) or, after construction, from `utils/convert.py`.

    `device` defaults to CUDA and raises when there is none; tests pass
    `device="cpu"`."""

    def __init__(self, cfg: VideoKNetConfig, *, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        if not isinstance(cfg, VideoKNetConfig):
            raise NotImplementedError(
                f"{type(cfg).__name__} is an image K-Net config: build it with "
                f"video_knet_tpu_torch.models.knet.KNet")
        if cfg.track_head_type not in ("kernel_embed", "query_fuse", "roi_gt_box"):
            raise ValueError(f"unknown track_head_type {cfg.track_head_type!r}")
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone, frozen_stages=cfg.frozen_stages,
                                       drop_path_rate=cfg.backbone_drop_path_rate,
                                       norm_eval=cfg.norm_eval)
        # parameters no loss reaches (data parallelism has DDP look for
        # them): the backbone's, and with roi_gt_box the last stage's link
        self.leaves_parameters_unused = (
            getattr(self.backbone, "leaves_parameters_unused", False)
            or (cfg.track_head_type == "roi_gt_box" and cfg.link_previous))
        self.neck = build_neck(cfg.neck_type, self.backbone)
        self.rpn_head = ConvKernelHead(cfg.rpn,
                                      in_channels=pyramid_width(self.backbone, self.neck))
        self.num_stages = cfg.num_stages
        for s in range(cfg.num_stages):
            self.add_module(f"mask_head_{s}", KernelUpdateHead(
                cfg.head,
                with_previous=cfg.link_previous and s == cfg.num_stages - 1,
                previous_type=cfg.previous_type,
                previous_link=cfg.previous_link,
            ))
        t = cfg.track
        if cfg.track_head_type == "query_fuse":
            self.track_embed = QueryTrackEmbed(t.in_channels, t.in_channels,
                                               t.query_fc_out_channels)
        elif cfg.track_head_type == "roi_gt_box":
            self.roi_track_head = ROITrackHead(cfg.rpn.out_channels, t.embed_channels)
        else:
            self.track_embed = TrackEmbed(t.in_channels, t.embed_channels, t.num_fcs)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.eval()
        self.to(device)

    @property
    def heads(self) -> list[KernelUpdateHead]:
        return [getattr(self, f"mask_head_{s}") for s in range(self.num_stages)]

    def extract_feat(self, img: torch.Tensor,
                     generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """`generator` draws the backbone's stochastic depth (training); None
        turns it off. Backbones without one ignore it."""
        with span("vk.model.backbone_neck"):
            return backbone_and_neck(self.backbone, self.neck, img, generator)

    def _stages(self, rpn_out: RPNOutputs, previous_obj_feats: torch.Tensor | None):
        outs = []
        object_feats = rpn_out.proposal_feats
        mask_preds = rpn_out.mask_preds
        obj_track = None
        for s, head in enumerate(self.heads):
            prev = previous_obj_feats if s == self.num_stages - 1 else None
            with span("vk.model.stage"):
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
        feats = self.extract_feat(img)
        with span("vk.model.init_head"):
            rpn_out = self.rpn_head(feats)
        outs, obj_track = self._stages(rpn_out, previous_obj_feats)
        return BranchOutput(rpn_out, outs, obj_track)

    def forward_train(self, img: torch.Tensor, ref_img: torch.Tensor,
                      generator: torch.Generator | None = None,
                      gt_masks: torch.Tensor | None = None,
                      ref_gt_masks: torch.Tensor | None = None):
        """Joint train forward: one backbone / neck / init-head pass over
        [ref; key], the ref stages plain, the key stages linked to the ref
        branch's final kernels (gradients flow through both). `generator`
        draws the backbone's stochastic depth (`extract_feat`).

        Returns (key, ref, key_embeds, ref_embeds); the embeddings cover all
        N proposals ([B, N, D]; the loss gathers the assigned ones). With
        `track_head_type='roi_gt_box'` they are RoIAligned at the GT masks'
        boxes instead, GT-slot aligned [B, G, D]: `gt_masks` / `ref_gt_masks`
        [B, G, h, w] are required then."""
        b = img.shape[0]
        with batch_blocks(2):  # [ref; key]: two slices of the global batch
            feats = self.extract_feat(torch.cat([ref_img, img]), generator)
            with span("vk.model.init_head"):
                both = self.rpn_head(feats)

        def half(sl: slice) -> RPNOutputs:
            return RPNOutputs(*(x[sl] for x in both[:-1]), init_kernels=both.init_kernels)

        rpn_ref, rpn_key = half(slice(0, b)), half(slice(b, None))
        ref_outs, ref_track = self._stages(rpn_ref, None)
        ref = BranchOutput(rpn_ref, ref_outs, ref_track)
        prev_obj = ref_outs[-1].object_feats
        key_outs, key_track = self._stages(rpn_key, prev_obj if self.cfg.link_previous else None)
        key = BranchOutput(rpn_key, key_outs, key_track)
        if self.cfg.track_head_type == "roi_gt_box":
            if gt_masks is None or ref_gt_masks is None:
                raise ValueError("track_head_type='roi_gt_box' trains on the GT masks' boxes: "
                                 "pass gt_masks and ref_gt_masks")
            return (key, ref, self._roi_embed(rpn_key.x_feats, gt_masks),
                    self._roi_embed(rpn_ref.x_feats, ref_gt_masks))
        n = self.cfg.num_proposals
        key_src = key_track if key_track is not None else key_outs[-1].object_feats
        return key, ref, self.embed(key_src[:, :n]), self.embed(ref_outs[-1].object_feats[:, :n])

    def _roi_embed(self, x_feats: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """RoIAlign track embeddings at mask-derived boxes. masks [B, M, h, w]
        (GT slots at train time, sigmoid mask probabilities at test time);
        the boxes are in mask pixels, rescaled to `x_feats` by the width
        ratio. On a band, `x_feats` is gathered into the whole map and
        `masks` are whole."""
        x_feats = whole_map(x_feats)
        boxes = torch.stack([masks_to_boxes(m) for m in masks])
        with off_band():
            return self.roi_track_head(x_feats, boxes, x_feats.shape[2] / masks.shape[-1])

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
        if cfg.track_head_type == "roi_gt_box":
            # RoI embeddings at the predicted masks' boxes
            probs = torch.sigmoid(last.scaled_mask_preds[:, : cfg.num_proposals].float())
            embeds = self._roi_embed(key.rpn_out.x_feats, probs)
        else:
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


def _track_loss_one(key_emb, ref_emb, key_valid, ref_valid, key_ids, ref_ids, *,
                    loss_track_weight: float, aux_weight: float, aux_neg_pos_ub: int,
                    aux_neg_margin: float):
    """One image's MultiPosCE + L2 aux on GT-slot-aligned embeddings [G, D]:
    rows and columns are GT slots, invalid pairs have target -1."""
    pair_valid = key_valid[:, None] & ref_valid[None, :]
    same = (key_ids[:, None] == ref_ids[None, :]) & pair_valid
    targets = torch.where(pair_valid, same.to(torch.int32),
                          torch.full_like(same, -1, dtype=torch.int32))
    weights = (same.sum(1) > 0).float()
    zero = torch.zeros((), device=key_emb.device)
    loss_track = L.multi_pos_cross_entropy(key_emb @ ref_emb.T, targets, weights,
                                           loss_weight=loss_track_weight, avg_factor=weights.sum())
    loss_track = torch.where(weights.sum() > 0, loss_track, zero)
    key_n = key_emb / torch.clamp(torch.linalg.norm(key_emb, dim=-1, keepdim=True), min=1e-12)
    ref_n = ref_emb / torch.clamp(torch.linalg.norm(ref_emb, dim=-1, keepdim=True), min=1e-12)
    loss_aux = L.l2_track_aux_loss(key_n @ ref_n.T, targets, neg_pos_ub=aux_neg_pos_ub,
                                   neg_margin=aux_neg_margin, loss_weight=aux_weight)
    return loss_track, torch.where(pair_valid.any(), loss_aux, zero)


def _query_match_loss_one(key_emb_g, ref_emb_g, key_valid, ref_valid, key_ids, ref_ids, *,
                          loss_weight: float) -> torch.Tensor:
    """One image's match-score cross entropy on GT-slot-aligned query
    embeddings [G, D]: key against ref correlations behind a leading all-zero
    "new object" column; the target is the matching ref slot + 1, or 0."""
    score = key_emb_g @ ref_emb_g.T  # [G, G]
    score = torch.where(ref_valid[None, :], score, torch.full_like(score, -1e9))
    score = torch.cat([torch.zeros_like(score[:, :1]), score], dim=1)  # [G, 1 + G]
    same = (key_ids[:, None] == ref_ids[None, :]) & ref_valid[None, :]
    # argmax of a bool row: its first True (torch.argmax of ties is not
    # guaranteed to take the first on every device)
    first = torch.where(same, torch.arange(same.shape[1], device=same.device)[None],
                        same.shape[1]).amin(dim=1)
    target = torch.where(same.any(dim=1), first + 1, 0)
    ce = -torch.log_softmax(score, dim=1).gather(1, target[:, None])[:, 0]
    w = key_valid.float()
    return loss_weight * (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def video_knet_costs(key: BranchOutput, ref: BranchOutput, gt: PanopticGT,
                     ref_gt: PanopticGT, cfg: VideoKNetConfig):
    """Every assignment problem of a step, in solve order: key init head +
    stages, the key tracking assign on the final outputs, then the same for
    the ref branch. Returns (costs list of [B, N, G], valids list of [B, G])."""
    n_prop = cfg.num_proposals
    nt = cfg.num_thing_classes

    def track_cost(last, branch_gt):
        return detached_cost(last.scaled_mask_preds[:, :n_prop], branch_gt.masks, branch_gt.labels,
                     last.cls_score[:, :n_prop, :nt], cfg.assigner.cls_weight, cfg)

    key_costs = branch_assignment_costs(key.rpn_out, key.stage_outs, gt, cfg)
    ref_costs = branch_assignment_costs(ref.rpn_out, ref.stage_outs, ref_gt, cfg)
    nk = len(key_costs)
    costs = (key_costs + [track_cost(key.stage_outs[-1], gt)]
             + ref_costs + [track_cost(ref.stage_outs[-1], ref_gt)])
    return costs, [gt.valid] * (nk + 1) + [ref_gt.valid] * (nk + 1)


def video_knet_loss(model_out: tuple[BranchOutput, BranchOutput],
                    embeds: tuple[torch.Tensor, torch.Tensor], gt: PanopticGT,
                    ref_gt: PanopticGT, cfg: VideoKNetConfig) -> dict[str, torch.Tensor]:
    """All VPS losses: key init head and stages, the same for the ref branch
    (suffixes `_ref_rpn`, `_ref`), and the tracking losses."""
    key, ref = model_out
    # all problems of the step in ONE solve (one kernel launch on the card)
    with span("vk.train.assign"):
        g2p, p2g = solve_lanes(*video_knet_costs(key, ref, gt, ref_gt, cfg))
    nk = len(g2p) // 2 - 1
    key_assigns, key_p2g = g2p[:nk], p2g[nk]
    ref_assigns, ref_p2g = g2p[nk + 1:2 * nk + 1], p2g[2 * nk + 1]

    losses = rpn_loss(key.rpn_out, gt, cfg, gt_of_pred=key_assigns[0])
    losses.update(iter_head_losses(key.stage_outs, gt, cfg, assignments=key_assigns[1:])[0])
    ref_losses = rpn_loss(ref.rpn_out, ref_gt, cfg, gt_of_pred=ref_assigns[0])
    losses.update({f"{k}_ref_rpn": v for k, v in ref_losses.items()})
    ref_iter = iter_head_losses(ref.stage_outs, ref_gt, cfg, assignments=ref_assigns[1:])[0]
    losses.update({f"{k}_ref": v for k, v in ref_iter.items()})

    key_emb, ref_emb = embeds
    t = cfg.track
    if cfg.track_head_type == "roi_gt_box":
        # GT-slot-aligned RoI embeddings: no gather at the assignments
        losses.update(roi_track_loss(
            key_emb, ref_emb, gt.valid, ref_gt.valid, gt.instance_ids, ref_gt.instance_ids,
            loss_track_weight=t.loss_track_weight, aux_weight=t.loss_track_aux_weight))
        return losses
    key_emb_g = gather_rows(key_emb, torch.clamp(key_p2g, min=0))
    ref_emb_g = gather_rows(ref_emb, torch.clamp(ref_p2g, min=0))
    key_valid = (key_p2g >= 0) & gt.valid
    ref_valid = (ref_p2g >= 0) & ref_gt.valid
    if cfg.track_head_type == "query_fuse":
        losses["loss_match"] = global_mean(torch.stack([_query_match_loss_one(
            key_emb_g[i], ref_emb_g[i], key_valid[i], ref_valid[i], gt.instance_ids[i],
            ref_gt.instance_ids[i], loss_weight=t.match_loss_weight)
            for i in range(key_emb.shape[0])]))
        return losses
    per_image = [_track_loss_one(
        key_emb_g[i], ref_emb_g[i], key_valid[i], ref_valid[i], gt.instance_ids[i],
        ref_gt.instance_ids[i], loss_track_weight=t.loss_track_weight,
        aux_weight=t.loss_track_aux_weight, aux_neg_pos_ub=t.aux_neg_pos_ub,
        aux_neg_margin=t.aux_neg_margin) for i in range(key_emb.shape[0])]
    losses["loss_track"] = global_mean(torch.stack([lt for lt, _ in per_image]))
    losses["loss_track_aux"] = global_mean(torch.stack([la for _, la in per_image]))
    return losses
