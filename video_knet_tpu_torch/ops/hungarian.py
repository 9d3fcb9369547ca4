"""On-device Hungarian (linear sum assignment) for mask matching, and the
K-Net matching costs.

Counterpart of `video_knet_tpu/ops/hungarian.py`. The reference runs the
Jonker-Volgenant shortest-augmenting-path solve as `lax.while_loop`s on the
device, so the train step never waits on the host. A torch loop would sync
the host at every augmentation; here the solve is the CUDA kernel
`ops/kernels/hungarian.py:solve` (one warp per problem, every problem of a
step in one launch), with a numpy copy of the same steps as the CPU route.

Rectangular problems (N predictions x G ground truths, G <= N) are solved
transposed, [G, N], so the sequential depth is G augmentations; invalid GT
rows get an all-zero cost row (their matches add the same constant to every
assignment) and are masked out afterwards.

On a band of the image rows (the band split of the mesh's `model` axis)
the mask costs' sums over pixels are the band's, summed over the `model`
group before the ratios (`parallel/model_axis.py:model_sum`), so that the
solve, replicated, sees the whole map's costs. Under the frame split the
tube costs (`tubes`: rows over the clip's frames) hold this rank's frames,
and their sums are summed over the group (`frame_sum`); per-frame costs
stay local.
"""

from __future__ import annotations

import torch

from video_knet_tpu_torch.ops.kernels.hungarian import solve as hungarian
from video_knet_tpu_torch.parallel.model_axis import frame_sum, level_height, model_sum


def gt_rows(cost: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """[L, N, M] prediction-x-GT costs and [L, M] GT validity -> the [L, M, N]
    problems the solve takes: one row a GT slot, invalid slots all zero."""
    return torch.where(col_valid[..., None], cost.transpose(-1, -2).float(),
                       torch.zeros((), device=cost.device)).contiguous()


def pad_and_solve(cost: torch.Tensor, col_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cost [L, N, M] prediction-x-GT costs (anything in invalid columns);
    col_valid [L, M] bool; M <= N. All L problems in one solve.

    Returns (gt_of_pred [L, N] int32, -1 unmatched; pred_of_gt [L, M] int32,
    -1 for invalid GT columns)."""
    n_pred, m = cost.shape[-2:]
    if m > n_pred:
        raise ValueError(f"expected num predictions >= max num GTs, got {n_pred} < {m}")
    pred_of_gt = hungarian(gt_rows(cost, col_valid))  # [L, M], every row matched
    pred_of_gt = torch.where(col_valid, pred_of_gt, torch.full_like(pred_of_gt, -1))
    lanes = cost.shape[0]
    gts = torch.arange(m, dtype=torch.int32, device=cost.device).expand(lanes, m)
    # invalid GT columns write into a dropped extra column n_pred
    slot = torch.where(col_valid, pred_of_gt, torch.full_like(pred_of_gt, n_pred)).long()
    gt_of_pred = torch.full((lanes, n_pred + 1), -1, dtype=torch.int32, device=cost.device)
    gt_of_pred.scatter_(1, slot, torch.where(col_valid, gts, torch.full_like(gts, -1)))
    return gt_of_pred[:, :n_pred], pred_of_gt


def focal_cls_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor, *, weight: float = 2.0,
                   alpha: float = 0.25, gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """mmdet FocalLossCost: [..., N, C] logits x [..., M] labels -> [..., N, M]."""
    scores = torch.sigmoid(cls_logits.float())
    neg_cost = -torch.log(1.0 - scores + eps) * (1.0 - alpha) * scores ** gamma
    pos_cost = -torch.log(scores + eps) * alpha * (1.0 - scores) ** gamma
    diff = pos_cost - neg_cost
    idx = torch.clamp(gt_labels, min=0).long()[..., None, :].expand(*diff.shape[:-1], -1)
    return weight * torch.gather(diff, -1, idx)


def _flat(m: torch.Tensor) -> torch.Tensor:
    return m.reshape(*m.shape[:-2], -1).float()


def dice_cost(mask_logits: torch.Tensor, gt_masks: torch.Tensor, *, weight: float = 4.0,
              eps: float = 1e-3, tubes: bool = False) -> torch.Tensor:
    """DiceCost(pred_act=True), sigmoid clamped to [0.001, 1]:
    [..., N, H, W] logits x [..., M, H, W] -> [..., N, M]. `tubes`: rows
    over the clip's frames (summed over them under the frame split)."""
    p = _flat(torch.clamp(torch.sigmoid(mask_logits.float()), 0.001, 1.0))
    t = _flat(gt_masks)
    a, b, c = (frame_sum if tubes else model_sum)(
        p @ t.transpose(-1, -2), (p * p).sum(-1), (t * t).sum(-1))
    d = (2.0 * a) / ((b + eps)[..., :, None] + (c + eps)[..., None, :])
    return weight * (-d)


def mask_cost(mask_logits: torch.Tensor, gt_masks: torch.Tensor, *,
              weight: float = 1.0, area: int | None = None, tubes: bool = False) -> torch.Tensor:
    """MaskCost(pred_act=True), sigmoid clamped to [0.01, 1]:
    -(positive agreement + negative agreement) / area, the area HW (the
    whole map's, on a band) unless given. `tubes`: rows over the clip's
    frames (summed over them under the frame split)."""
    hw = mask_logits.shape[-1] * level_height(*mask_logits.shape[-2:]) if area is None else area
    p = _flat(torch.clamp(torch.sigmoid(mask_logits.float()), 0.01, 1.0))
    t = _flat(gt_masks)
    pos, p_sum, t_sum = (frame_sum if tubes else model_sum)(
        p @ t.transpose(-1, -2), p.sum(-1), t.sum(-1))
    neg = hw - p_sum[..., :, None] - t_sum[..., None, :] + pos
    return weight * (-(pos + neg) / hw)


def hungarian_cost_matrix(mask_logits: torch.Tensor, gt_masks: torch.Tensor,
                          cls_logits: torch.Tensor | None, gt_labels: torch.Tensor | None, *,
                          cls_weight: float = 2.0, dice_weight: float = 4.0,
                          mask_weight: float = 1.0) -> torch.Tensor:
    """focal-cls * 2 + dice * 4 + mask * 1: [..., N, M] float32."""
    cost = (dice_cost(mask_logits, gt_masks, weight=dice_weight)
            + mask_cost(mask_logits, gt_masks, weight=mask_weight))
    if cls_logits is not None and gt_labels is not None and cls_weight != 0:
        cost = cost + focal_cls_cost(cls_logits, gt_labels, weight=cls_weight)
    return cost


def assign(mask_logits: torch.Tensor, gt_masks: torch.Tensor, gt_valid: torch.Tensor,
           cls_logits: torch.Tensor | None = None, gt_labels: torch.Tensor | None = None,
           **cost_kwargs) -> tuple[torch.Tensor, torch.Tensor]:
    """One-image MaskHungarianAssigner.assign with fixed GT slots:
    (gt_of_pred [N], pred_of_gt [M])."""
    cost = hungarian_cost_matrix(mask_logits, gt_masks, cls_logits, gt_labels, **cost_kwargs)
    g2p, p2g = pad_and_solve(cost[None], gt_valid[None])
    return g2p[0], p2g[0]
