"""KNetVIS: clip-level video instance segmentation (YouTube-VIS): the clip
forward, the tube losses and the whole-clip decode.

Counterpart of `video_knet_tpu/models/vis/knet_vis.py`. A clip
[B, T, H, W, 3] runs the backbone and neck with T folded into the batch, a
per-frame K-Net (the init head with the temporal positional encoding, then
`KernelIterHead`; instance-only, no stuff rows), then the clip tracker head
(`models/vis/clip_head.py`) fuses the per-frame kernels into clip "tube"
kernels. The `volume` mode replaces the per-frame branch with the volume
init head (`models/vis/volume_head.py`).

Training: the per-frame init-head and stage losses on the per-frame view of
the GT tubes (`frame_gt_from_clip`), plus each clip stage's tube losses,
where predictions and GT tubes are flattened over T*H*W and matched per
clip. Unlike the per-frame head, the tube assignment of a clip stage
s < `tracker_assign_stages` uses stage s's OWN detached outputs. Every
assignment problem of a step, per-frame and tube, goes into one solve
(`knet_vis_costs`, `models/knet.py:solve_lanes`).

GT tubes live in fixed slots (`ClipGT`): slot g holds instance g's mask in
every frame (zeros where it is absent).

Decode (one clip): the top-k (proposal, class) pairs over the clip scores
of the last clip stage with a cls branch; the masks of the last stage, one
track id per tube.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from video_knet_tpu_torch.config_vis import VISConfig
from video_knet_tpu_torch.models.backbones import build_backbone, build_neck
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead, RPNOutputs
from video_knet_tpu_torch.models.kernel_iter_head import (
    KernelIterHead,
    StageOutput,
    upscale_masks,
)
from video_knet_tpu_torch.models.knet import (
    branch_assignment_costs,
    iter_head_losses,
    mask_losses,
    rpn_loss,
    solve_lanes,
    top_k,
)
from video_knet_tpu_torch.models.layers import (
    init_parameters,
    resize_bilinear,
    resize_mask_bilinear,
)
from video_knet_tpu_torch.models.vis.clip_head import ClipKernelHead, ClipStageOutput
from video_knet_tpu_torch.models.vis.volume_head import (
    ClipVolumeKernelHead,
    VolumeRPNOutputs,
)
from video_knet_tpu_torch.ops import hungarian as hung
from video_knet_tpu_torch.ops import losses as L
from video_knet_tpu_torch.ops.targets import (
    PanopticGT,
    build_semantic_map,
    gather_rows,
    pred_of_gt_from,
)
from video_knet_tpu_torch.parallel.mesh import global_sum
from video_knet_tpu_torch.utils.device import resolve_device, set_fp32_numerics

KERNEL_HEAD_MODES = ("frame", "volume")


class ClipGT(NamedTuple):
    """Fixed-slot GT tubes at mask-assign-stride resolution."""

    masks: torch.Tensor  # [B, G, T, H, W] float (zeros where the instance is absent)
    labels: torch.Tensor  # [B, G] int32
    valid: torch.Tensor  # [B, G] bool


class VISOutputs(NamedTuple):
    rpn_out: RPNOutputs | VolumeRPNOutputs  # per-frame (leading axis B*T), or the tubes
    frame_stage_outs: list[StageOutput]  # per-frame stages (B*T); empty in volume mode
    clip_stage_outs: list[ClipStageOutput]  # tracker stages (B, T, ...)


class KNetVIS(nn.Module):
    """The VIS model. Weights come from a seeded `generator` (flax's default
    initializers) or, after construction, from `utils/convert.py`; the
    module tree mirrors flax's (`backbone`, `neck`, `rpn_head`, `roi_head`,
    `tracker`).

    `device` defaults to CUDA and raises when there is none; tests pass
    `device="cpu"`. On CUDA it turns TF32 off for cuBLAS and cuDNN
    (`set_fp32_numerics`): the reference computes in fp32."""

    def __init__(self, cfg: VISConfig, *, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda":
            set_fp32_numerics()
        if cfg.kernel_head_mode not in KERNEL_HEAD_MODES:
            raise ValueError(f"kernel_head_mode={cfg.kernel_head_mode!r}")
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone, frozen_stages=cfg.frozen_stages,
                                       drop_path_rate=cfg.backbone_drop_path_rate,
                                       norm_eval=cfg.norm_eval)
        # parameters no loss reaches (data parallelism has DDP look for them)
        self.leaves_parameters_unused = getattr(self.backbone, "leaves_parameters_unused", False)
        self.neck = build_neck(cfg.neck_type, self.backbone)
        volume = cfg.kernel_head_mode == "volume"
        if volume:
            self.rpn_head = ClipVolumeKernelHead(cfg.rpn, in_channels=self.neck.out_channels)
        else:
            self.rpn_head = ConvKernelHead(cfg.rpn, in_channels=self.neck.out_channels)
            self.roi_head = KernelIterHead(cfg.head, num_stages=cfg.num_stages)
        self.tracker = ClipKernelHead(
            cfg.head, num_stages=cfg.tracker_num_stages,
            assign_stages=cfg.tracker_assign_stages, num_proposals=cfg.num_proposals,
            query_merge_method=cfg.query_merge_method, with_mask_init=cfg.with_mask_init,
            merge_queries=not (volume or cfg.direct_tracker))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.eval()
        self.to(device)

    def forward(self, clip: torch.Tensor, generator: torch.Generator | None = None) -> VISOutputs:
        """clip [B, T, H, W, 3]. `generator` draws the backbone's stochastic
        depth (training); None turns it off."""
        cfg = self.cfg
        b, t = clip.shape[:2]
        fpn = self.neck(self.backbone(clip.reshape(b * t, *clip.shape[2:]), generator))
        if cfg.kernel_head_mode == "volume":
            vol = self.rpn_head(fpn, num_frames=t)
            clip_outs = self.tracker(vol.x_feats, None, vol.tube_mask_preds,
                                     clip_kernels=vol.proposal_feats)
            return VISOutputs(vol, [], clip_outs)

        rpn_out = self.rpn_head(fpn, num_frames=t)
        frame_outs = self.roi_head(rpn_out.x_feats, rpn_out.proposal_feats, rpn_out.mask_preds)
        last = frame_outs[-1]
        n = cfg.num_proposals
        x_clip = rpn_out.x_feats.reshape(b, t, *rpn_out.x_feats.shape[1:])
        kernels_clip = last.object_feats[:, :n, 0, :].reshape(b, t, n, -1)
        masks_clip = last.mask_preds[:, :n].reshape(b, t, n, *last.mask_preds.shape[-2:])
        clip_outs = self.tracker(
            x_clip, kernels_clip, masks_clip,
            direct_kernels=rpn_out.init_kernels if cfg.direct_tracker else None)
        return VISOutputs(rpn_out, frame_outs, clip_outs)


def frame_gt_from_clip(gt: ClipGT) -> PanopticGT:
    """The per-frame view of the tubes (T folded into the batch). A slot is
    valid in a frame only where the instance appears."""
    b, g, t, h, w = gt.masks.shape
    dev = gt.masks.device
    masks = gt.masks.transpose(1, 2).reshape(b * t, g, h, w)
    present = masks.reshape(b * t, g, -1).sum(-1) > 0
    labels = gt.labels[:, None].expand(b, t, g).reshape(b * t, g)
    valid = gt.valid[:, None].expand(b, t, g).reshape(b * t, g) & present
    ids = torch.arange(g, dtype=torch.int32, device=dev)[None].expand(b * t, g)
    return PanopticGT(
        masks=masks,
        labels=labels,
        valid=valid,
        instance_ids=torch.where(valid, ids, torch.full_like(ids, -1)),
        sem_masks=torch.zeros((b * t, 0, h, w), dtype=torch.float32, device=dev),
        sem_valid=torch.zeros((b * t, 0), dtype=torch.bool, device=dev),
    )


def _tubes(masks: torch.Tensor) -> torch.Tensor:
    """[B, T, N, H, W] -> [B, N, T, H, W]."""
    return masks.transpose(1, 2)


def tube_cost(scaled_masks: torch.Tensor, cls_score: torch.Tensor | None, gt: ClipGT,
              cfg: VISConfig) -> torch.Tensor:
    """[B, N, G] Hungarian costs of detached tubes [B, T, N, H, W] against the
    GT tubes: dice + mask (+ focal cls) over the flattened T*H*W. The mask
    cost divides by N*T*H*W, as the reference's vmapped cost does (it reads
    the area off its flattened [N, T*H*W] operand)."""
    b, t, n, h, w = scaled_masks.shape
    g = gt.masks.shape[1]
    pred = _tubes(scaled_masks.detach()).reshape(b, n, t * h, w)
    gt_tubes = gt.masks.reshape(b, g, t * h, w)
    a = cfg.assigner
    cost = (hung.dice_cost(pred, gt_tubes, weight=a.dice_weight)
            + hung.mask_cost(pred, gt_tubes, weight=a.mask_weight, area=n * t * h * w))
    if cls_score is not None:
        cost = cost + hung.focal_cls_cost(cls_score.detach(), gt.labels, weight=a.cls_weight)
    return cost


def _volume_scaled(vol: VolumeRPNOutputs, cfg: VISConfig) -> torch.Tensor:
    """The tube init masks at the assign stride, [B, T, N, Hs, Ws]."""
    return upscale_masks(vol.tube_mask_preds, cfg.rpn.feat_downsample_stride)


def knet_vis_costs(outs: VISOutputs, gt: ClipGT, cfg: VISConfig):
    """Every assignment problem of a step, in solve order: in frame mode the
    per-frame branch's (init head + assign stages, [B*T, N, G] each, on
    `frame_gt_from_clip`), in volume mode the init tubes' ([B, N, G], no
    cls); then each clip stage s < tracker_assign_stages on its own outputs
    ([B, N, G]). Returns (costs, valids)."""
    if cfg.kernel_head_mode == "volume":
        costs = [tube_cost(_volume_scaled(outs.rpn_out, cfg), None, gt, cfg)]
        valids = [gt.valid]
    else:
        fgt = frame_gt_from_clip(gt)
        costs = branch_assignment_costs(outs.rpn_out, outs.frame_stage_outs, fgt, cfg)
        valids = [fgt.valid] * len(costs)
    for out in outs.clip_stage_outs[:cfg.tracker_assign_stages]:
        costs.append(tube_cost(out.scaled_mask_preds, out.cls_score, gt, cfg))
        valids.append(gt.valid)
    return costs, valids


def _tube_mask_losses(scaled_masks: torch.Tensor, gt_of_pred: torch.Tensor, gt: ClipGT,
                      mask_weight: float, dice_weight: float, names) -> dict:
    """Mask BCE and dice on the GATHERED matched tubes ([B, G, T*H*W], the
    weighted means of the dense [B, N, ...] form without materializing it)."""
    b, g = gt.valid.shape
    p2g = pred_of_gt_from(gt_of_pred, g)
    rows = gather_rows(_tubes(scaled_masks), torch.clamp(p2g, min=0))  # [B, G, T, H, W]
    pred, tgt = rows.reshape(b * g, -1), gt.masks.reshape(b * g, -1)
    w = (p2g >= 0).float().reshape(b * g)
    return mask_losses(pred, tgt, w, mask_weight, dice_weight, names)


def tube_stage_loss(out: ClipStageOutput, gt_of_pred: torch.Tensor, gt: ClipGT,
                    cfg: VISConfig, prefix: str) -> dict[str, torch.Tensor]:
    """One clip stage's tube losses: focal cls (clip stages) and the mask
    losses of the matched tubes."""
    h = cfg.head
    c = cfg.num_classes
    b, n = gt_of_pred.shape
    losses = {}
    if out.cls_score is not None:
        matched = gt_of_pred >= 0
        labels = gather_rows(gt.labels, torch.clamp(gt_of_pred, min=0))
        labels = torch.where(matched, labels, torch.full_like(labels, c))
        losses[f"{prefix}_loss_cls"] = L.sigmoid_focal_loss(
            out.cls_score.reshape(b * n, c), labels.reshape(b * n), num_classes=c,
            gamma=h.focal_gamma, alpha=h.focal_alpha, loss_weight=h.loss_cls_weight,
            avg_factor=torch.clamp(global_sum(matched.float().sum()), min=1.0))
    losses.update(_tube_mask_losses(out.scaled_mask_preds, gt_of_pred, gt, h.loss_mask_weight,
                                    h.loss_dice_weight,
                                    (f"{prefix}_loss_mask", f"{prefix}_loss_dice")))
    return losses


def volume_rpn_loss(vol: VolumeRPNOutputs, gt: ClipGT, cfg: VISConfig,
                    gt_of_pred: torch.Tensor) -> dict[str, torch.Tensor]:
    """The volume init head's losses given its tube assignment [B, N]: mask
    and dice on the matched init tubes, and the per-frame sigmoid focal
    loss of the linearly upsampled seg logits."""
    r = cfg.rpn
    c = cfg.num_classes
    losses = _tube_mask_losses(_volume_scaled(vol, cfg), gt_of_pred, gt, r.loss_mask_weight,
                               r.loss_dice_weight, ("loss_rpn_mask", "loss_rpn_dice"))
    b, t, h, w, _ = vol.seg_preds.shape
    s = r.feat_downsample_stride
    seg = resize_bilinear(vol.seg_preds.reshape(b * t, h, w, c), (h * s, w * s))
    seg_t = build_semantic_map(frame_gt_from_clip(gt), num_thing_classes=cfg.num_thing_classes,
                               num_classes=c).reshape(-1)
    losses["loss_rpn_seg"] = L.sigmoid_focal_loss(
        seg.reshape(-1, c), seg_t, num_classes=c, loss_weight=r.loss_seg_weight,
        avg_factor=torch.clamp(global_sum((seg_t < c).float().sum()), min=1.0))
    return losses


def knet_vis_loss(outs: VISOutputs, gt: ClipGT, cfg: VISConfig) -> dict[str, torch.Tensor]:
    """The per-frame init-head and stage losses (volume mode: the tube init
    losses instead), then every clip stage's tube losses. All assignments of
    the step come from ONE solve (one kernel launch on the card)."""
    assigns, _ = solve_lanes(*knet_vis_costs(outs, gt, cfg))
    if cfg.kernel_head_mode == "volume":
        losses = volume_rpn_loss(outs.rpn_out, gt, cfg, assigns[0])
        tube_assigns = assigns[1:]
    else:
        fgt = frame_gt_from_clip(gt)
        a = 1 + min(cfg.assign_stages, len(outs.frame_stage_outs))
        losses = rpn_loss(outs.rpn_out, fgt, cfg, gt_of_pred=assigns[0])
        losses.update(iter_head_losses(outs.frame_stage_outs, fgt, cfg,
                                       assignments=assigns[1:a])[0])
        tube_assigns = assigns[a:]
    gt_of_pred = None
    for s, out in enumerate(outs.clip_stage_outs):
        if s < cfg.tracker_assign_stages:
            gt_of_pred = tube_assigns[s]
        for k, v in tube_stage_loss(out, gt_of_pred, gt, cfg, f"tracker_s{s}").items():
            losses[k] = v * cfg.tracker_stage_loss_weights[s]
    return losses


class VISPrediction(NamedTuple):
    masks: torch.Tensor  # [T, max_per_img, H, W] float mask logits per frame
    labels: torch.Tensor  # [max_per_img] int32
    scores: torch.Tensor  # [max_per_img]
    track_ids: torch.Tensor  # [max_per_img] int32 (one per tube)


def vis_decode(outs: VISOutputs, cfg: VISConfig,
               out_hw: tuple[int, int] | None = None) -> VISPrediction:
    """Whole-clip decode of a batch-of-1 forward: the top-k (proposal, class)
    pairs of the last clip stage with a cls branch (ties to the lower index,
    as `lax.top_k`), the masks of the last stage, shared tube ids."""
    cls_stage = outs.clip_stage_outs[cfg.tracker_assign_stages - 1]
    last = outs.clip_stage_outs[-1]
    c = cfg.num_classes
    k = cfg.test.max_per_img
    top_scores, top_idx = top_k(torch.sigmoid(cls_stage.cls_score[0]).reshape(-1), k)
    mask_idx = torch.div(top_idx, c, rounding_mode="floor")
    masks = last.scaled_mask_preds[0][:, mask_idx]  # [T, K, H, W]
    if out_hw is not None:
        masks = resize_mask_bilinear(masks, tuple(out_hw))
    return VISPrediction(
        masks=masks,
        labels=(top_idx % c).to(torch.int32),
        scores=top_scores,
        track_ids=torch.arange(k, dtype=torch.int32, device=masks.device),
    )
