"""Loss library for kernel-based segmentation: fixed-shape tensors and explicit
per-element weights, no data-dependent shapes (so no host syncs).

Counterpart of `video_knet_tpu/ops/losses.py`, function for function:
dice, sigmoid focal, mask BCE, softmax CE with ignore_index, the
multi-positive CE and L2 auxiliary loss of the tracker, the rank CE. "Mean
over positives" is sum(loss * w) / max(sum(w), eps) throughout.

On a band of the image rows (the band split of the mesh's `model` axis)
the losses over pixels take the band's pixels: the dice loss sums its
three per-row sums over the `model` group before the ratio, and the pixel
means (mask BCE, the softmax CE of the rank and semantic losses, the
semantic sigmoid focal loss with `over_pixels`) sum each band's partial
sum there over a normalizer of the whole map (`parallel/model_axis.py:
model_sum`, `model_count`); the default normalizers count the whole map's
pixels. Every rank of the `model` group then holds the whole loss.

Under the frame split (VIS) a loss over rows of single frames is this
rank's frames' share (its rows' sum over the caller's global normalizer;
the caller sums the shares, `models/vis/knet_vis.py:knet_vis_loss`); the
dice loss of rows that span the clip's frames (`tubes`) sums its per-row
sums over the `model` group before the ratio (`frame_sum`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_knet_tpu_torch.parallel.model_axis import frame_sum, in_band, model_count, model_sum

_EPS = 1e-12
_NEG = torch.finfo(torch.float32).min


def _at_least_eps(avg_factor):
    """max(avg_factor, eps) for a tensor or a number (no host round trip)."""
    if torch.is_tensor(avg_factor):
        return torch.clamp(avg_factor, min=_EPS)
    return max(float(avg_factor), _EPS)


def _weighted_mean(loss: torch.Tensor, weight: torch.Tensor | None,
                   avg_factor=None) -> torch.Tensor:
    """sum(loss * weight) / avg_factor, avg_factor defaulting to sum(weight)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if weight is None:
            return loss.mean()
        avg_factor = weight.sum()
    return loss.sum() / _at_least_eps(avg_factor)


def _pixel_mean(loss: torch.Tensor, weight: torch.Tensor | None, avg_factor=None) -> torch.Tensor:
    """`_weighted_mean` of a loss over pixels: on a band, the band's partial
    sum summed over the `model` group, the default normalizer the whole
    map's."""
    if in_band() is None:
        return _weighted_mean(loss, weight, avg_factor)
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        avg_factor = model_count(loss.new_tensor(float(loss.numel())) if weight is None
                                 else weight.sum())
    return model_sum(loss.sum()) / _at_least_eps(avg_factor)


def dice_loss(pred_logits: torch.Tensor, target: torch.Tensor,
              weight: torch.Tensor | None = None, *, eps: float = 1e-3,
              loss_weight: float = 1.0, avg_factor=None, tubes: bool = False) -> torch.Tensor:
    """pred_logits / target [P, ...spatial]; weight [P]. 1 - 2 sum(p t) /
    (sum(p^2) + eps + sum(t^2) + eps) on sigmoid probabilities. The per-row
    sums are summed over the bands on a band, or with `tubes` (rows over
    the clip's frames) over the frames under the frame split."""
    p = torch.sigmoid(pred_logits.float()).reshape(pred_logits.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    a, b, c = (frame_sum if tubes else model_sum)((p * t).sum(1), (p * p).sum(1), (t * t).sum(1))
    d = (2.0 * a) / ((b + eps) + (c + eps))
    return loss_weight * _weighted_mean(1.0 - d, weight, avg_factor)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """`jax.nn.one_hot`: an out-of-range label (the background) is all zeros."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).float()


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_weights: torch.Tensor | None = None, *, num_classes: int,
                       gamma: float = 2.0, alpha: float = 0.25, loss_weight: float = 1.0,
                       avg_factor=None, over_pixels: bool = False) -> torch.Tensor:
    """logits [P, C]; labels [P] in [0, num_classes] (num_classes = background);
    label_weights [P] or [P, C]. avg_factor defaults to the positive count,
    at least 1. `over_pixels`: P are pixels (the semantic loss), summed
    over the bands on a band."""
    logits = logits.float()
    one_hot = _one_hot(labels, num_classes)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * one_hot + p * (1.0 - one_hot)
    focal_weight = (alpha * one_hot + (1.0 - alpha) * (1.0 - one_hot)) * pt ** gamma
    loss = _bce_with_logits(logits, one_hot) * focal_weight
    if label_weights is not None:
        if label_weights.dim() == 1:
            label_weights = label_weights[:, None]
        loss = loss * label_weights
    total = loss.sum()
    if avg_factor is None:
        pos = ((labels >= 0) & (labels < num_classes)).float().sum()
        avg_factor = torch.clamp(model_count(pos) if over_pixels else pos, min=1.0)
    if over_pixels:
        total = model_sum(total)
    return loss_weight * total / _at_least_eps(avg_factor)


def binary_cross_entropy(pred_logits: torch.Tensor, target: torch.Tensor,
                         weight: torch.Tensor | None = None, *, loss_weight: float = 1.0,
                         avg_factor=None) -> torch.Tensor:
    """Mask BCE: the mean of elementwise BCE-with-logits over weighted
    elements; weight [P] is broadcast over the spatial dims."""
    loss = _bce_with_logits(pred_logits.float(), target.float())
    w = None
    if weight is not None:
        w = weight.reshape(*weight.shape, *(1,) * (loss.dim() - weight.dim())).expand(loss.shape)
    return loss_weight * _pixel_mean(loss, w, avg_factor)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, ignore_index: int,
                          loss_weight: float = 1.0, avg_factor=None) -> torch.Tensor:
    """logits [..., C]; labels [...] (pixels): the mean over non-ignored
    entries."""
    logits = logits.float()
    valid = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return loss_weight * _pixel_mean(nll, valid, avg_factor)


def multi_pos_cross_entropy(sim: torch.Tensor, targets: torch.Tensor,
                            weight: torch.Tensor | None = None, *, loss_weight: float = 1.0,
                            avg_factor=None) -> torch.Tensor:
    """sim [P, Q]; targets [P, Q] in {1 positive, 0 negative, -1 invalid};
    weight [P]. Per row log(1 + sum_pos exp(-s) * sum_neg exp(s))."""
    sim = sim.float()
    pos = targets == 1
    neg = targets == 0
    neg_inf = torch.full_like(sim, _NEG)
    lse_pos = torch.logsumexp(torch.where(pos, -sim, neg_inf), dim=1)
    lse_neg = torch.logsumexp(torch.where(neg, sim, neg_inf), dim=1)
    has_pair = pos.any(1) & neg.any(1)
    pair = torch.where(has_pair, lse_pos + lse_neg, torch.full_like(lse_pos, _NEG))
    loss = torch.logaddexp(torch.zeros_like(pair), pair)
    return loss_weight * _weighted_mean(loss, weight, avg_factor)


def l2_track_aux_loss(sim: torch.Tensor, targets: torch.Tensor, *, neg_pos_ub: int = 3,
                      pos_margin: float = 0.0, neg_margin: float = 0.1,
                      loss_weight: float = 1.0) -> torch.Tensor:
    """L2 on margin-shifted, clamped cosine similarities; when negatives
    outnumber neg_pos_ub x positives only the num_pos * neg_pos_ub hardest
    are kept (a stable rank over the whole matrix: static shapes, no
    boolean indexing)."""
    sim = sim.float()
    pos = targets == 1
    neg = targets == 0
    pred = sim
    if pos_margin > 0:
        pred = torch.where(pos, pred - pos_margin, pred)
    if neg_margin > 0:
        pred = torch.where(neg, pred - neg_margin, pred)
    pred = torch.clamp(pred, 0.0, 1.0)
    err = (pred - pos.float()) ** 2

    num_pos = pos.sum()
    num_neg = neg.sum()
    total = pos.numel()
    cap = num_pos * neg_pos_ub
    neg_err = torch.where(neg, err, torch.full_like(err, -1.0)).reshape(-1)
    order = torch.argsort(-neg_err, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(total, device=order.device))
    keep_neg = neg.reshape(-1) & (ranks < cap)
    apply_cap = (num_neg / (num_pos + 1) > neg_pos_ub) & (neg_pos_ub > 0)
    neg_w = torch.where(apply_cap, keep_neg.float(), neg.reshape(-1).float())
    w = pos.reshape(-1).float() + neg_w
    return loss_weight * _weighted_mean(err.reshape(-1), w)


def rank_cross_entropy(mask_logits: torch.Tensor, rank_target: torch.Tensor, *,
                       ignore_index: int = 255, loss_weight: float = 0.1) -> torch.Tensor:
    """mask_logits [N, H, W] as per-pixel class logits; rank_target [H, W]."""
    return softmax_cross_entropy(mask_logits.movedim(0, -1), rank_target,
                                 ignore_index=ignore_index, loss_weight=loss_weight)
