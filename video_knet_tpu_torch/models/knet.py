"""Image K-Net: the model, its training losses and its decodes.

Counterpart of `video_knet_tpu/models/knet.py`:
- `KNet` (`:29-53`): backbone, neck (the FPN or the MSDeformAttn pixel
  decoder), the init head `rpn_head` and the stage loop `roi_head`, with
  flax's module names; the image model every release Video K-Net is
  pretrained as (Cityscapes-STEP) and K-Net's own COCO panoptic and
  instance models.
- the loss block (`:56-400`): the Hungarian assignment costs of a branch
  (`branch_assignment_costs`, optionally at head resolution against pooled
  GT), one solve for all of them (`solve_assignments`), the init-head losses
  (`rpn_loss`), the per-stage losses on gathered rows (`stage_loss`,
  gather-then-upscale), `iter_head_losses` and `knet_loss`. Fixed GT slots,
  no data-dependent shapes; the assignment inputs are detached.
- the instance decode (`:404-451`): the top `max_per_img` (proposal, class)
  pairs of the thing scores, their masks upsampled, then the sigmoid.
- the panoptic decode (`:454-540`): top-k thing (proposal, class) pairs plus
  one row per stuff class, sigmoid, optional rescale, joint-argmax merge.
  `panoptic_decode_batch` decodes each image of a batch in turn and stacks
  the results (the reference vmaps the same function).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from video_knet_tpu_torch.config import KNetConfig
from video_knet_tpu_torch.models.backbones import build_backbone, build_neck
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead, RPNOutputs
from video_knet_tpu_torch.models.kernel_iter_head import (
    KernelIterHead,
    StageOutput,
    upscale_masks,
)
from video_knet_tpu_torch.models.layers import (
    init_parameters,
    resize_bilinear,
    resize_mask_bilinear,
    resize_nearest,
)
from video_knet_tpu_torch.ops import hungarian as hung
from video_knet_tpu_torch.ops import losses as L
from video_knet_tpu_torch.ops.panoptic import PanopticResult, merge_joint
from video_knet_tpu_torch.ops.targets import (
    PanopticGT,
    build_rank_target_gathered,
    build_semantic_map,
    build_stage_label_targets,
    gather_rows,
    pred_of_gt_from,
)
from video_knet_tpu_torch.parallel.mesh import global_sum
from video_knet_tpu_torch.utils.device import resolve_device, set_fp32_numerics
from video_knet_tpu_torch.utils.tree import tree_stack

# ------------------------------------------------------------------- model


class KNet(nn.Module):
    """The image model. Weights come from a seeded `generator` (flax's
    default initializers) or, after construction, from `utils/convert.py`.

    `device` defaults to CUDA and raises when there is none; tests pass
    `device="cpu"`. On CUDA it turns TF32 off for cuBLAS and cuDNN
    (`set_fp32_numerics`): the reference computes in fp32."""

    def __init__(self, cfg: KNetConfig, *, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda":
            set_fp32_numerics()
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone, frozen_stages=cfg.frozen_stages,
                                       drop_path_rate=cfg.backbone_drop_path_rate,
                                       norm_eval=cfg.norm_eval)
        # parameters no loss reaches (data parallelism has DDP look for them)
        self.leaves_parameters_unused = getattr(self.backbone, "leaves_parameters_unused", False)
        self.neck = build_neck(cfg.neck_type, self.backbone)
        self.rpn_head = ConvKernelHead(cfg.rpn, in_channels=self.neck.out_channels)
        self.roi_head = KernelIterHead(cfg.head, num_stages=cfg.num_stages)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.eval()
        self.to(device)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None
                ) -> tuple[RPNOutputs, list[StageOutput]]:
        """img [B, H, W, 3] normalized. `generator` draws the backbone's
        stochastic depth (training); None turns it off."""
        rpn_out = self.rpn_head(self.neck(self.backbone(img, generator)))
        return rpn_out, self.roi_head(rpn_out.x_feats, rpn_out.proposal_feats,
                                      rpn_out.mask_preds)

# ------------------------------------------------------------------ losses


def detached_cost(masks, gt_masks, gt_labels, cls, cls_weight: float,
                  cfg: KNetConfig) -> torch.Tensor:
    """[B, N, G] matching costs of detached predictions."""
    return hung.hungarian_cost_matrix(
        masks.detach(), gt_masks, None if cls is None else cls.detach(), gt_labels,
        cls_weight=cls_weight, dice_weight=cfg.assigner.dice_weight,
        mask_weight=cfg.assigner.mask_weight)


def branch_assignment_costs(rpn_out, stage_outs: list[StageOutput], gt: PanopticGT,
                            cfg: KNetConfig) -> list[torch.Tensor]:
    """All Hungarian cost matrices of one branch, [rpn, stage 0 .. A-1], each
    [B, N, G], to be solved together. Stage s is assigned on the previous
    stage's outputs (the init head's for s = 0). With
    `cfg.assigner.coarse_costs` the costs use head-resolution masks against
    average-pooled GT instead of masks upsampled to the assign stride."""
    n_prop = cfg.num_proposals
    coarse = cfg.assigner.coarse_costs

    def gt_masks_for(masks):
        f = gt.masks.shape[-1] // masks.shape[-1]
        if not coarse or f <= 1:
            return gt.masks
        b, g, hs, ws = gt.masks.shape
        return gt.masks.reshape(b, g, hs // f, f, ws // f, f).mean(dim=(3, 5))

    def cost(masks, cls, cls_weight):
        return detached_cost(masks, gt_masks_for(masks), gt.labels, cls, cls_weight, cfg)

    rpn_thing = (rpn_out.thing_mask_preds if coarse
                 else upscale_masks(rpn_out.thing_mask_preds, cfg.rpn.feat_downsample_stride))
    costs = [cost(rpn_thing, None, 0.0)]
    prev_masks = (rpn_out.mask_preds if coarse
                  else upscale_masks(rpn_out.mask_preds, cfg.head.mask_upsample_stride))[:, :n_prop]
    prev_cls = None
    for s in range(min(cfg.assign_stages, len(stage_outs))):
        cls = None if prev_cls is None else prev_cls[:, :n_prop, :cfg.num_thing_classes]
        costs.append(cost(prev_masks, cls, cfg.assigner.cls_weight if cls is not None else 0.0))
        prev_masks = (stage_outs[s].mask_preds if coarse
                      else stage_outs[s].scaled_mask_preds)[:, :n_prop]
        prev_cls = stage_outs[s].cls_score
    return costs


def solve_lanes(costs: list[torch.Tensor], valids: list[torch.Tensor]):
    """Solve L cost sets [B_l, N, G] (valid [B_l, G] each; the leading sizes
    may differ) as ONE Hungarian solve over sum B_l problems. Returns
    (gt_of_pred list of [B_l, N], pred_of_gt list of [B_l, G])."""
    sizes = [c.shape[0] for c in costs]
    g2p, p2g = hung.pad_and_solve(torch.cat(costs), torch.cat(valids))
    return list(g2p.split(sizes)), list(p2g.split(sizes))


def solve_assignments(costs: list[torch.Tensor], valid: torch.Tensor):
    """`solve_lanes` with one validity for every cost set."""
    return solve_lanes(costs, [valid] * len(costs))


def _rank_loss_batched(scaled_masks: torch.Tensor, rank_target: torch.Tensor,
                       weight: float) -> torch.Tensor:
    """CE over the N mask logits of each pixel, ignore 255, averaged over the
    global batch's labelled pixels."""
    return L.softmax_cross_entropy(scaled_masks.movedim(1, -1), rank_target, ignore_index=255,
                                   loss_weight=weight,
                                   avg_factor=global_sum((rank_target != 255).float().sum()))


def mask_losses(pred: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor, mask_weight: float,
                dice_weight: float, names) -> dict[str, torch.Tensor]:
    """Mask BCE and dice of rows pred / tgt [P, ...] weighted by w [P], each
    averaged over the global batch's weights (BCE's broadcast over a row's
    elements)."""
    rows = global_sum(w.sum())
    return {names[0]: L.binary_cross_entropy(pred, tgt, w, loss_weight=mask_weight,
                                             avg_factor=rows * pred[0].numel()),
            names[1]: L.dice_loss(pred, tgt, w, loss_weight=dice_weight, avg_factor=rows)}


def _mask_losses(rows_pred, rows_t, rows_w, mask_weight, dice_weight, names):
    b, r = rows_w.shape
    hw = rows_pred.shape[-2:]
    pred, tgt, w = rows_pred.reshape(b * r, *hw), rows_t.reshape(b * r, *hw), rows_w.reshape(b * r)
    return mask_losses(pred, tgt, w, mask_weight, dice_weight, names)


def rpn_loss(rpn_out, gt: PanopticGT, cfg: KNetConfig,
             gt_of_pred: torch.Tensor) -> dict[str, torch.Tensor]:
    """Init-head losses given its assignment [B, N]: mask BCE and dice on the
    gathered matched rows, the rank CE, and the semantic loss on the
    linearly upsampled seg logits (softmax CE in the video config, sigmoid
    focal otherwise)."""
    c = cfg.num_classes
    r = cfg.rpn
    scaled = upscale_masks(rpn_out.thing_mask_preds, r.feat_downsample_stride)
    p2g = pred_of_gt_from(gt_of_pred, gt.masks.shape[1])
    rows_w = (p2g >= 0).float()
    safe = torch.clamp(p2g, min=0)
    losses = _mask_losses(gather_rows(scaled, safe), gt.masks, rows_w, r.loss_mask_weight,
                          r.loss_dice_weight, ("loss_rpn_mask", "loss_rpn_dice"))
    if r.loss_rank_weight > 0:
        rank_t = build_rank_target_gathered(gt.masks, rows_w, safe, ignore_label=255)
        losses["loss_rpn_rank"] = _rank_loss_batched(scaled, rank_t, r.loss_rank_weight)
    seg_targets = build_semantic_map(gt, num_thing_classes=cfg.num_thing_classes, num_classes=c)
    h, w = rpn_out.seg_preds.shape[1:3]
    seg_scaled = resize_bilinear(rpn_out.seg_preds,
                                 (h * r.feat_downsample_stride, w * r.feat_downsample_stride))
    if r.seg_use_sigmoid:
        flat_t = seg_targets.reshape(-1)
        num_dense_pos = torch.clamp(global_sum((flat_t < c).float().sum()), min=1.0)
        losses["loss_rpn_seg"] = L.sigmoid_focal_loss(
            seg_scaled.reshape(-1, c), flat_t, num_classes=c, loss_weight=r.loss_seg_weight,
            avg_factor=num_dense_pos)
    else:
        losses["loss_rpn_seg"] = L.softmax_cross_entropy(
            seg_scaled, seg_targets, ignore_index=c, loss_weight=r.loss_seg_weight,
            avg_factor=global_sum((seg_targets != c).float().sum()))
    return losses


def stage_loss(out: StageOutput, gt_of_pred: torch.Tensor, gt: PanopticGT, cfg: KNetConfig,
               prefix: str) -> dict[str, torch.Tensor]:
    """One KernelUpdateHead stage: focal cls over all rows; mask BCE and dice
    on the G matched thing rows plus the S stuff rows, gathered at head
    resolution and only then upscaled; the rank CE over all rows."""
    h = cfg.head
    c = cfg.num_classes
    s = cfg.num_stuff_classes
    labels, label_weights, num_pos = build_stage_label_targets(
        gt_of_pred, gt, num_thing_classes=cfg.num_thing_classes, num_stuff_classes=s)
    b, n_tot = labels.shape
    n_prop = n_tot - s
    losses = {f"{prefix}_loss_cls": L.sigmoid_focal_loss(
        out.cls_score.reshape(b * n_tot, c), labels.reshape(b * n_tot),
        label_weights.reshape(b * n_tot, c), num_classes=c, gamma=h.focal_gamma,
        alpha=h.focal_alpha, loss_weight=h.loss_cls_weight,
        avg_factor=torch.clamp(global_sum(num_pos), min=1.0))}
    p2g = pred_of_gt_from(gt_of_pred[:, :n_prop], gt.masks.shape[1])
    safe = torch.clamp(p2g, min=0)
    mp = out.mask_preds
    rows_small = torch.cat([gather_rows(mp[:, :n_prop], safe), mp[:, n_prop:]], dim=1)
    rows_pred = upscale_masks(rows_small, h.mask_upsample_stride)
    rows_t = torch.cat([gt.masks, gt.sem_masks], dim=1)
    rows_w = torch.cat([(p2g >= 0).float(), gt.sem_valid.float()], dim=1)
    losses.update(_mask_losses(rows_pred, rows_t, rows_w, h.loss_mask_weight,
                               h.loss_dice_weight, (f"{prefix}_loss_mask", f"{prefix}_loss_dice")))
    if h.loss_rank_weight > 0:
        stuff_rows = n_prop + torch.arange(s, dtype=safe.dtype, device=safe.device)
        orig_idx = torch.cat([safe, stuff_rows[None].expand(b, s)], dim=1)
        rank_t = build_rank_target_gathered(rows_t, rows_w, orig_idx, ignore_label=255)
        losses[f"{prefix}_loss_rank"] = _rank_loss_batched(out.scaled_mask_preds, rank_t,
                                                           h.loss_rank_weight)
    return losses


def iter_head_losses(stage_outs: list[StageOutput], gt: PanopticGT, cfg: KNetConfig,
                     assignments: list[torch.Tensor]):
    """Per-stage losses given one [B, N] assignment per assign stage (stage s
    assigned on the previous stage's detached outputs, `solve_assignments`).
    Returns (losses, last stage's gt_of_pred)."""
    losses: dict[str, torch.Tensor] = {}
    gt_of_pred = None
    for s, out in enumerate(stage_outs):
        if s < cfg.assign_stages:
            gt_of_pred = assignments[s]
        for k, v in stage_loss(out, gt_of_pred, gt, cfg, f"s{s}").items():
            losses[k] = v * cfg.stage_loss_weights[s]
    return losses, gt_of_pred


def knet_loss(rpn_out, stage_outs: list[StageOutput], gt: PanopticGT,
              cfg: KNetConfig) -> dict[str, torch.Tensor]:
    costs = branch_assignment_costs(rpn_out, stage_outs, gt, cfg)
    assigns, _ = solve_assignments(costs, gt.valid)
    losses = rpn_loss(rpn_out, gt, cfg, gt_of_pred=assigns[0])
    losses.update(iter_head_losses(stage_outs, gt, cfg, assignments=assigns[1:])[0])
    return losses


# ------------------------------------------------------------------ decode


class InstancePrediction(NamedTuple):
    """COCO instance-segmentation decode (fixed `max_per_img` slots)."""

    masks: torch.Tensor  # [max_per_img, H, W] mask probabilities
    labels: torch.Tensor  # [max_per_img] int32 class labels
    scores: torch.Tensor  # [max_per_img]


def instance_decode(rpn_out, stage_outs: list[StageOutput], cfg: KNetConfig,
                    out_hw: tuple[int, int] | None = None) -> InstancePrediction:
    """Decode of a batch-of-1 forward."""
    last = stage_outs[-1]
    return instance_decode_single(last.cls_score[0], last.scaled_mask_preds[0], cfg, out_hw)


def instance_decode_single(cls_score_logits: torch.Tensor, mask_preds: torch.Tensor,
                           cfg: KNetConfig,
                           out_hw: tuple[int, int] | None = None) -> InstancePrediction:
    """cls_score_logits [N_tot, C]; mask_preds [N_tot, Hs, Ws]: the sigmoid
    over the (proposal, class) pairs of the things, the top `max_per_img`,
    their masks bilinearly resized to `out_hw`, then the sigmoid. Masks stay
    probabilities (`cfg.test.mask_thr` thresholds them at dump time)."""
    c = cfg.num_thing_classes
    n_prop = cfg.num_proposals
    scores = torch.sigmoid(cls_score_logits[:n_prop, :c].float()).reshape(-1)
    top_scores, top_idx = top_k(scores, cfg.test.max_per_img)
    labels = (top_idx % c).int()
    masks = mask_preds[:n_prop][torch.div(top_idx, c, rounding_mode="floor")]
    if out_hw is not None and tuple(masks.shape[-2:]) != tuple(out_hw):
        masks = resize_mask_bilinear(masks, tuple(out_hw))
    return InstancePrediction(torch.sigmoid(masks.float()), labels, top_scores)


class PanopticPrediction(NamedTuple):
    result: PanopticResult
    thing_kernels: torch.Tensor  # [max_per_img, K*K, C] kernels of the top-k things
    thing_mask_idx: torch.Tensor  # [max_per_img] source proposal of each top-k thing
    seg_preds: torch.Tensor  # [H, W, C] semantic logits


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` on a 1-D tensor: ties go to the lower index (a stable
    descending sort; `torch.topk` makes no such promise)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def panoptic_decode(rpn_out, stage_outs: list[StageOutput], cfg: KNetConfig,
                    out_hw: tuple[int, int] | None = None) -> PanopticPrediction:
    """Decode of a batch-of-1 forward."""
    last = stage_outs[-1]
    return panoptic_decode_single(
        last.cls_score[0], last.scaled_mask_preds[0], last.object_feats[0],
        rpn_out.seg_preds[0], cfg, out_hw,
    )


def panoptic_decode_batch(rpn_out, stage_outs: list[StageOutput], cfg: KNetConfig,
                          out_hw: tuple[int, int] | None = None) -> PanopticPrediction:
    """Decode of every image of a batch (multi-stream serving); each field
    gains a leading batch axis."""
    last = stage_outs[-1]
    return tree_stack([
        panoptic_decode_single(last.cls_score[i], last.scaled_mask_preds[i],
                               last.object_feats[i], rpn_out.seg_preds[i], cfg, out_hw)
        for i in range(last.cls_score.shape[0])
    ])


def panoptic_decode_single(cls_score_logits: torch.Tensor, mask_preds: torch.Tensor,
                           object_feats: torch.Tensor, seg_preds: torch.Tensor,
                           cfg: KNetConfig,
                           out_hw: tuple[int, int] | None = None) -> PanopticPrediction:
    """cls_score_logits [N_tot, C]; mask_preds [N_tot, Hs, Ws];
    object_feats [N_tot, K*K, C]; seg_preds [h, w, C]."""
    t = cfg.test
    cls_score = torch.sigmoid(cls_score_logits)
    n_prop = cfg.num_proposals
    nt = cfg.num_thing_classes

    thing_scores_full = cls_score[:n_prop, :nt].reshape(-1)
    k_top = min(t.max_per_img, thing_scores_full.shape[0])
    top_scores, top_idx = top_k(thing_scores_full, k_top)
    mask_idx = torch.div(top_idx, nt, rounding_mode="floor")
    thing_labels = (top_idx % nt).int()
    thing_masks = mask_preds[:n_prop][mask_idx]

    stuff_scores = torch.diagonal(cls_score[n_prop:, nt:])
    stuff_labels = nt + torch.arange(cfg.num_stuff_classes, dtype=torch.int32,
                                     device=cls_score.device)
    masks = torch.cat([thing_masks, mask_preds[n_prop:]], dim=0)
    resize = out_hw is not None and tuple(masks.shape[-2:]) != tuple(out_hw)
    upsample_after = resize and t.fast_decode
    if resize and not upsample_after:
        masks = resize_mask_bilinear(masks, tuple(out_hw))
    probs = torch.sigmoid(masks.float())
    scores = torch.cat([top_scores, stuff_scores]).float()
    labels = torch.cat([thing_labels, stuff_labels])

    res = merge_joint(probs, scores, labels, num_thing_classes=nt,
                      instance_score_thr=t.instance_score_thr, overlap_thr=t.overlap_thr)
    if upsample_after:
        res = res._replace(panoptic_seg=resize_nearest(res.panoptic_seg, tuple(out_hw)))
    thing_kernels = object_feats[:n_prop][mask_idx]
    return PanopticPrediction(res, thing_kernels, mask_idx, seg_preds)
