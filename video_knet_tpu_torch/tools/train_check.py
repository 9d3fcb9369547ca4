"""Weights for comparing two devices' VPS train steps.

The mask pools binarize their inputs at a hard threshold. An input closer to
the threshold than the two devices' forward error (~1e-5 in logits on the
card) may binarize differently on each, which is the threshold's nature and
not a kernel's error. A comparison of the card's train step with the CPU's
therefore takes the first weight seed whose CPU forward keeps every such
input `MARGIN` from its threshold (`margin_seed`); `chip_smoke.py`
(train-check, swin-check) and the card tests share it, and
`swin_check_cfg`, the Swin slice's small configuration.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from video_knet_tpu_torch.config import VideoKNetConfig
from video_knet_tpu_torch.models.layers import resize_mask_bilinear
from video_knet_tpu_torch.models.video.knet_vps import BranchOutput, VideoKNet
from video_knet_tpu_torch.train.vps import make_synthetic_batch

MARGIN = 1e-4  # logits; ~10x the card's forward error at the threshold
SEEDS = 16


def mask_pool_margin(branch: BranchOutput, cfg: VideoKNetConfig) -> float:
    """The smallest distance, in logits, between an input of the branch's
    hard-threshold mask pools (the init head's, threshold 0.5, and each
    stage's) and its threshold."""
    def dist(x, thr):
        return float((x - math.log(thr / (1 - thr))).abs().min())

    margin = dist(branch.rpn_out.thing_mask_preds, 0.5)
    prev = branch.rpn_out.mask_preds
    for out in branch.stage_outs:
        margin = min(margin, dist(resize_mask_bilinear(prev, out.mask_preds.shape[-2:]),
                                  cfg.head.hard_mask_thr))
        prev = out.mask_preds
    return margin


def margin_seed(cfg: VideoKNetConfig, hw: tuple[int, int]) -> tuple[int, float]:
    """(the first weight seed below SEEDS whose CPU forward on
    `make_synthetic_batch(cfg, 1, hw, seed=0)` keeps MARGIN, its margin).
    `VideoKNet(cfg, generator=torch.Generator().manual_seed(seed))` builds
    those weights."""
    batch = make_synthetic_batch(cfg, 1, hw, seed=0, device="cpu")
    for seed in range(SEEDS):
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
        with torch.no_grad():
            key, ref, _, _ = model.forward_train(batch.img, batch.ref_img)
        margin = min(mask_pool_margin(key, cfg), mask_pool_margin(ref, cfg))
        if margin >= MARGIN:
            return seed, margin
    raise AssertionError(f"no weight seed below {SEEDS} keeps the mask-pool inputs "
                         f"{MARGIN} from the threshold")


def swin_check_cfg(tiny):
    """The Swin slice's check configuration: Swin-tiny under `tiny`'s
    64-channel heads and 20 proposals (the trained tiny config,
    `trained_golden.tiny_cfg()`), VIP-Seg's class split (58 thing, 66 stuff:
    86 kernels), the Swin KITTI-STEP link (`previous_link=
    'update_dynamic_cov'`, `previous_type='update'`), and the score gates at
    zero so that random weights keep and track things. Only field names are
    read, so the JAX package's config of the same fields maps the same way."""
    split = dict(num_classes=124, num_thing_classes=58, num_stuff_classes=66)
    return dataclasses.replace(
        tiny, backbone="swin_tiny", num_thing_classes=58, num_stuff_classes=66,
        previous_link="update_dynamic_cov", previous_type="update",
        rpn=dataclasses.replace(tiny.rpn, **split),
        head=dataclasses.replace(tiny.head, **split),
        test=dataclasses.replace(tiny.test, instance_score_thr=0.0),
        tracker=dataclasses.replace(tiny.tracker, init_score_thr=0.0, obj_score_thr=0.0,
                                    match_score_thr=0.05))
