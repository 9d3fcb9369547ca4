"""Weights and ReLU patterns for comparing two devices' train steps.

The mask pools binarize their inputs at a hard threshold. An input closer to
the threshold than the two devices' forward error (~1e-5 in logits on the
card for R-50 VPS; ~5e-6 of a tensor's largest magnitude for the VIS check
model, whose logits are tens) may binarize differently on each, which is
the threshold's nature and not a kernel's error. A comparison of the card's
train step with the CPU's therefore takes the first weight seed whose CPU
forward keeps every such input `MARGIN` from its threshold (`margin_seed`
for VPS), or `VIS_MARGIN` of its tensor's largest magnitude
(`vis_margin_seed` for VIS clips and `image_margin_seed` for the image
K-Net, which also keep the decode's top-k logits that far apart).
`chip_smoke.py` (train-check, swin-check, vis-check, image-check) and the
card tests share them, and the small configurations of the Swin slice
(`swin_check_cfg`), of the VIS slice (`vis_check_cfg`), of the image
slice (`image_check_cfg`, built by `image_check_model`) and of the other
track heads (`track_check_cfg`).

A ReLU is a kink of the same kind for gradients: an input within the
devices' forward error of zero may pass on one device and not the other,
which changes the gradient behind it by the whole gradient arriving at that
element (in the VIS check model one such element can move the backbone's
gradients by several times the check's tolerance). No weight seed keeps
every ReLU input of a step clear of zero, so `relu_pattern` records the
card's ReLU decisions and replays them on the CPU: the CPU step then
follows the card at exactly the elements the devices cannot decide alike,
and is the CPU's step everywhere else (a replayed element's value differs
from the CPU's own ReLU by less than the forward error).

`test_whole_video`'s masks are logits thresholded at 0, a hard decision of
the same kind on outputs no seed search covers: `vis_near_ties` measures
the card-vs-CPU difference of each video's logits, holds it within
`VIS_MASK_TOL` of their scale and marks the pixels within twice of it of 0,
and `vis_results_agree` holds two devices' YT-VIS results equal but there.
Where the difference exceeds that bound, `vis_flips` names the hard
decisions inside a clip's forward (`vis_decisions`) that the devices took
otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from video_knet_tpu_torch.config import KNetConfig, VideoKNetConfig
from video_knet_tpu_torch.config_vis import VISConfig
from video_knet_tpu_torch.models.kernel_head import RPNOutputs
from video_knet_tpu_torch.models.knet import KNet, top_k
from video_knet_tpu_torch.models.layers import resize_mask_bilinear
from video_knet_tpu_torch.models.video.knet_vps import BranchOutput, VideoKNet
from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS, VISOutputs
from video_knet_tpu_torch.train import image as train_image
from video_knet_tpu_torch.train import vis as train_vis
from video_knet_tpu_torch.train.vps import make_synthetic_batch

MARGIN = 1e-4  # logits; ~10x the card's forward error at the threshold
VIS_MARGIN = 2e-5  # of a tensor's largest magnitude; ~4x the card's relative forward error
SEEDS = 16
VIS_SCORE_TOL = 1e-5  # card vs CPU, absolute, on `test_whole_video`'s sigmoid scores
VIS_MASK_TOL = 1e-4  # card vs CPU, `test_whole_video`'s mask logits, relative to their scale


def _dist(x: torch.Tensor, thr: float, relative: bool = False) -> float:
    """The smallest distance of x from logit(thr); relative: as a share of
    max |x|, and 0 when no element passes (a pool that pools nothing checks
    nothing)."""
    t0 = math.log(thr / (1 - thr))
    d = float((x - t0).abs().min())
    if not relative:
        return d
    return d / max(float(x.abs().max()), 1e-30) if bool((x > t0).any()) else 0.0


def _stage_inputs(prev: torch.Tensor, outs) -> list[torch.Tensor]:
    """The stages' mask-pool inputs: each stage pools the previous masks
    resized to its own mask size."""
    inputs = []
    for out in outs:
        inputs.append(resize_mask_bilinear(prev, out.mask_preds.shape[-2:]))
        prev = out.mask_preds
    return inputs


def _stage_margin(prev: torch.Tensor, outs, thr: float, relative: bool = False) -> float:
    return min((_dist(x, thr, relative) for x in _stage_inputs(prev, outs)), default=math.inf)


def mask_pool_margin(branch: BranchOutput, cfg: VideoKNetConfig) -> float:
    """The smallest distance, in logits, between an input of the branch's
    hard-threshold mask pools (the init head's, threshold 0.5, and each
    stage's) and its threshold."""
    return min(_dist(branch.rpn_out.thing_mask_preds, 0.5),
               _stage_margin(branch.rpn_out.mask_preds, branch.stage_outs,
                             cfg.head.hard_mask_thr))


def vps_decisions(model: VideoKNet, batch) -> tuple[list, list]:
    """The discrete decisions of a VPS train forward on `batch` (no
    gradient), each tensor batch-major: (every hard-threshold mask pool's
    inputs against its threshold: the init head's at 0.5 and each stage's
    at `head.hard_mask_thr`, in both branches; every assignment of the
    step's Hungarian problems, `video_knet_costs` solved as the loss solves
    them). Two batch splits that decide alike give equal tensors once the
    splits' are stacked."""
    from video_knet_tpu_torch.models.video.knet_vps import solve_lanes, video_knet_costs

    cfg = model.cfg
    t_stage = math.log(cfg.head.hard_mask_thr / (1 - cfg.head.hard_mask_thr))
    with torch.no_grad():
        key, ref, _, _ = model.forward_train(batch.img, batch.ref_img, None, batch.gt.masks,
                                             batch.ref_gt.masks)
        out = []
        for branch in (key, ref):
            out.append(branch.rpn_out.thing_mask_preds > 0)
            out += [x > t_stage for x in _stage_inputs(branch.rpn_out.mask_preds,
                                                        branch.stage_outs)]
        gt_of_pred, _ = solve_lanes(*video_knet_costs(key, ref, batch.gt, batch.ref_gt, cfg))
    return out, list(gt_of_pred)


def vis_decisions(outs: VISOutputs, cfg: VISConfig) -> dict[str, tuple[torch.Tensor, float]]:
    """The inputs of a VIS clip's hard mask-pool decisions by name, in the
    forward's order, each with its threshold as a probability: the init
    head's (`init`; `tubes`, the volume head's tube pool), the per-frame
    stages' (`frame0`, ...) and the clip stages' (`clip0`, ...), which start
    from the per-frame head's last masks, or the init tubes. Without
    `with_mask_init`, whose re-initialized masks are not among the outputs."""
    if cfg.with_mask_init:
        raise NotImplementedError("the fc_mask_init masks are not among the outputs")
    thr = cfg.head.hard_mask_thr
    if cfg.kernel_head_mode == "volume":
        tubes = outs.rpn_out.tube_mask_preds
        first, clip_prev = {"tubes": (tubes, 0.5)}, tubes
    else:
        n = cfg.num_proposals
        b, t = outs.clip_stage_outs[0].mask_preds.shape[:2]
        last = outs.frame_stage_outs[-1].mask_preds[:, :n]
        first = {"init": (outs.rpn_out.thing_mask_preds, 0.5)}
        first.update((f"frame{i}", (x, thr)) for i, x in enumerate(
            _stage_inputs(outs.rpn_out.mask_preds, outs.frame_stage_outs)))
        clip_prev = last.reshape(b, t, *last.shape[1:])
    return {**first, **{f"clip{i}": (x, thr) for i, x in enumerate(
        _stage_inputs(clip_prev, outs.clip_stage_outs))}}


def _decode_logits(outs: VISOutputs, cfg: VISConfig) -> torch.Tensor:
    """The (proposal, class) logits whose top-k `vis_decode` takes."""
    return outs.clip_stage_outs[cfg.tracker_assign_stages - 1].cls_score[0]


def vis_margin(outs: VISOutputs, cfg: VISConfig) -> float:
    """The smallest distance, as a share of its tensor's largest magnitude,
    between a hard decision's input and its boundary in a VIS clip: the
    mask pools (`vis_decisions`) and the decode's top-k order (the gaps
    between adjacent logits of the k + 1 best (proposal, class) pairs of the
    first batch entry); 0 if a pool has no input above its threshold."""
    return min(_top_k_gap(_decode_logits(outs, cfg), cfg.test.max_per_img),
               *(_dist(x, thr, True) for x, thr in vis_decisions(outs, cfg).values()))


def vis_flips(a: VISOutputs, b: VISOutputs, cfg: VISConfig) -> dict[str, int]:
    """The hard decisions that two forwards of one clip (two devices) took
    otherwise: per `vis_decisions` entry, the elements binarized
    differently, and `top_k`, the decode's top-k positions whose (proposal,
    class) differs; only the nonzero counts, in the forward's order."""
    flips = {}
    for (name, (xa, thr)), (xb, _) in zip(vis_decisions(a, cfg).items(),
                                          vis_decisions(b, cfg).values()):
        t0 = math.log(thr / (1 - thr))
        flips[name] = int(((xa.cpu() > t0) != (xb.cpu() > t0)).sum())
    k = cfg.test.max_per_img
    ia, ib = (top_k(torch.sigmoid(_decode_logits(o, cfg).cpu()).reshape(-1), k)[1]
              for o in (a, b))
    flips["top_k"] = int((ia != ib).sum())
    return {name: n for name, n in flips.items() if n}


def _top_k_gap(cls: torch.Tensor, k: int) -> float:
    """The smallest gap between adjacent logits of the k + 1 best, as a
    share of max |cls|."""
    cls = cls.reshape(-1)
    best = torch.sort(cls, descending=True).values[:k + 1]
    return float((best[:-1] - best[1:]).min()) / max(float(cls.abs().max()), 1e-30)


def image_margin(rpn_out: RPNOutputs, stage_outs, cfg: KNetConfig) -> float:
    """`vis_margin` for one image K-Net forward: the init head's and the
    stages' mask pools, and the decode's top-k order over the last stage's
    (proposal, thing class) logits of the first image."""
    cls = stage_outs[-1].cls_score[0, :cfg.num_proposals, :cfg.num_thing_classes]
    return min(_top_k_gap(cls, cfg.test.max_per_img),
               _dist(rpn_out.thing_mask_preds, 0.5, True),
               _stage_margin(rpn_out.mask_preds, stage_outs, cfg.head.hard_mask_thr, True))


def _first_seed(margin_of, limit: float = MARGIN) -> tuple[int, float]:
    for seed in range(SEEDS):
        margin = margin_of(seed)
        if margin >= limit:
            return seed, margin
    raise AssertionError(f"no weight seed below {SEEDS} keeps the hard decisions' inputs "
                         f"{limit} from their boundaries")


def margin_seed(cfg: VideoKNetConfig, hw: tuple[int, int]) -> tuple[int, float]:
    """(the first weight seed below SEEDS whose CPU forward on
    `make_synthetic_batch(cfg, 1, hw, seed=0)` keeps MARGIN, its margin).
    `VideoKNet(cfg, generator=torch.Generator().manual_seed(seed))` builds
    those weights."""
    batch = make_synthetic_batch(cfg, 1, hw, seed=0, device="cpu")

    def margin_of(seed: int) -> float:
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
        with torch.no_grad():
            key, ref, _, _ = model.forward_train(batch.img, batch.ref_img, None,
                                                 batch.gt.masks, batch.ref_gt.masks)
        return min(mask_pool_margin(key, cfg), mask_pool_margin(ref, cfg))

    return _first_seed(margin_of)


def vis_margin_seed(cfg: VISConfig, hw: tuple[int, int]) -> tuple[int, float]:
    """`margin_seed` for KNetVIS on `train/vis.py:make_synthetic_batch(cfg,
    1, hw, seed=0)`, by `vis_margin` against `VIS_MARGIN`."""
    batch = train_vis.make_synthetic_batch(cfg, 1, hw, seed=0, device="cpu")

    def margin_of(seed: int) -> float:
        model = KNetVIS(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
        with torch.no_grad():
            return vis_margin(model(batch.clip), cfg)

    return _first_seed(margin_of, VIS_MARGIN)


def image_margin_seed(cfg: KNetConfig, hw: tuple[int, int]) -> tuple[int, float]:
    """`margin_seed` for `image_check_model` on `train/image.py:
    make_synthetic_batch(cfg, 1, hw, seed=0)`, by `image_margin` against
    `VIS_MARGIN`."""
    batch = train_image.make_synthetic_batch(cfg, 1, hw, seed=0, device="cpu")

    def margin_of(seed: int) -> float:
        model = image_check_model(cfg, seed, "cpu")
        with torch.no_grad():
            return image_margin(*model(batch.img), cfg)

    return _first_seed(margin_of, VIS_MARGIN)


@contextlib.contextmanager
def relu_pattern(pattern: list, replay: bool = False):
    """Within the block, every `torch.nn.functional.relu` call appends its
    decision (input > 0, on the host) to `pattern`, in call order; with
    `replay`, each call instead applies the next recorded decision, x *
    decision, so that its gradient follows the recorded device's. Yields
    {"calls", "differ"}: the replayed calls and the elements whose own
    decision differs from the recorded one."""
    relu = F.relu
    recorded = iter(pattern)
    stats = {"calls": 0, "differ": 0}

    def patched(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
        if not replay:
            pattern.append((x > 0).detach().cpu())
            return relu(x)
        decision = next(recorded).to(x.device)
        if decision.shape != x.shape:
            raise ValueError(f"ReLU call {stats['calls']}: recorded {tuple(decision.shape)}, "
                             f"got {tuple(x.shape)}")
        stats["calls"] += 1
        stats["differ"] += int(((x > 0) != decision).sum())
        return x * decision.to(x.dtype)

    F.relu = patched
    try:
        yield stats
    finally:
        F.relu = relu


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


def track_check_cfg(tiny, track_head_type: str):
    """The check configuration of the other track heads: `tiny`'s MiT-b0
    under 64-channel heads, 20 proposals and 4 GT slots (the trained tiny
    config, `trained_golden.tiny_cfg()`, of either package: only field names
    are read) with `track_head_type` 'query_fuse' (1024-wide query
    embeddings) or 'roi_gt_box'."""
    return dataclasses.replace(tiny, track_head_type=track_head_type)


def vis_check_cfg(base):
    """The VIS slice's check configuration, from `base` (`VISConfig()` of
    either package: only field names are read): MiT-b0 under 64-channel
    heads (the trained tiny config's widths), 5 classes, 8 proposals, 4 tube
    slots, clips of 2 frames, the top 4 at decode."""
    split = dict(num_classes=5, num_thing_classes=5, num_stuff_classes=0)
    upd = dataclasses.replace(base.head.updator, in_channels=64, feat_channels=64,
                              out_channels=64)
    return dataclasses.replace(
        base, backbone="mit_b0", num_classes=5, num_proposals=8, num_frames=2, max_insts=4,
        rpn=dataclasses.replace(base.rpn, num_proposals=8, in_channels=64, out_channels=64,
                                fpn_feat_channels=64, **split),
        head=dataclasses.replace(base.head, in_channels=64, out_channels=64,
                                 feedforward_channels=256, updator=upd, **split),
        test=dataclasses.replace(base.test, max_per_img=4))


NECK_LAYERS = 1  # the check models' deformable encoder depth (the presets' is 6)


def shallow_neck(model: torch.nn.Module, num_layers: int = NECK_LAYERS) -> torch.nn.Module:
    """Keep the first `num_layers` encoder layers of a model's MSDeformAttn
    pixel decoder (the reference's decoder takes `num_layers`; no config
    field sets it). A model with another neck is returned as it is."""
    neck = model.neck
    if hasattr(neck, "num_encoder_levels"):
        for i in range(num_layers, neck.num_layers):
            delattr(neck, f"layer{i}")
        neck.num_layers = min(num_layers, neck.num_layers)
    return model


def image_check_cfg(base, *, instance: bool = False, deformable: bool = True):
    """The image slice's check configuration, from `base` (`KNetConfig()` of
    either package: only field names are read): MiT-b0 under 64-channel
    heads, 8 proposals, 4 GT slots, the top 4 at decode with the score gate
    at zero (random weights keep few things otherwise); 3 thing and 2 stuff
    classes, or with `instance` the COCO instance form (5 thing
    classes, no stuff rows, the seg branch's sigmoid loss); the
    MSDeformAttn neck unless `deformable` is off (`image_check_model` cuts
    its encoder to `NECK_LAYERS`)."""
    things, stuff = (5, 0) if instance else (3, 2)
    split = dict(num_classes=things + stuff, num_thing_classes=things, num_stuff_classes=stuff)
    upd = dataclasses.replace(base.head.updator, in_channels=64, feat_channels=64,
                              out_channels=64)
    return dataclasses.replace(
        base, backbone="mit_b0", num_proposals=8, max_insts=4,
        num_thing_classes=things, num_stuff_classes=stuff,
        neck_type="msdeform_pixel_decoder" if deformable else "fpn",
        rpn=dataclasses.replace(base.rpn, num_proposals=8, in_channels=64, out_channels=64,
                                fpn_feat_channels=64, cat_stuff_mask=not instance,
                                seg_use_sigmoid=True, **split),
        head=dataclasses.replace(base.head, in_channels=64, out_channels=64,
                                 feedforward_channels=256, updator=upd, **split),
        test=dataclasses.replace(base.test, max_per_img=4, instance_score_thr=0.0))


def image_check_model(cfg: KNetConfig, seed: int, device) -> KNet:
    """`KNet(cfg)` with weights from `seed`, its deformable encoder (if any)
    cut to `NECK_LAYERS`."""
    return shallow_neck(KNet(cfg, generator=torch.Generator().manual_seed(seed), device=device))


def vis_near_ties(card_model: KNetVIS, cpu_model: KNetVIS, cfg: VISConfig, ds,
                  hw: tuple[int, int], clip_len: int,
                  tol: float = VIS_MASK_TOL) -> tuple[dict, float, dict]:
    """Each video of `ds` through `test_whole_video`'s frames and clip loop
    with the same weights on the card and on the CPU. Returns ({video_id:
    [n, K, H, W] bool}, the worst difference as a share of its video's
    largest CPU |logit|, {video_id: one dict a clip}): a pixel is a near-tie
    where the CPU's mask logit lies within twice the video's card-vs-CPU
    difference of the CLI's threshold (0 on logits;
    `data/tta.py:near_threshold`); a clip's dict holds its difference as a
    share of the video's scale (`err`) and the hard decisions the devices
    took otherwise (`vis_flips`). Raises AssertionError, naming those
    decisions, where a video's difference exceeds `tol` of its scale."""
    from video_knet_tpu_torch.data.tta import near_threshold
    from video_knet_tpu_torch.tools.test_whole_video import (
        clip_runner,
        video_frames,
        video_prediction,
    )

    def run(model, frames):
        outs = []
        hook = model.register_forward_hook(lambda _m, _i, out: outs.append(out))
        try:
            return video_prediction(clip_runner(model, cfg, hw), frames, clip_len)[0], outs
        finally:
            hook.remove()

    near, worst, clips = {}, 0.0, {}
    for video in ds.videos:
        frames = video_frames(ds, video, hw)
        (card, card_outs), (cpu, cpu_outs) = run(card_model, frames), run(cpu_model, frames)
        if not cpu.min() < 0:
            raise AssertionError(f"video {video.video_id}: the decode gave no logit below 0")
        diff = np.abs(card - cpu)
        err = float(diff.max())
        scale = max(float(np.abs(cpu).max()), 1e-30)
        near[video.video_id] = near_threshold(cpu, 0.0, err)
        clips[video.video_id] = [
            dict(err=float(diff[i * clip_len : (i + 1) * clip_len].max()) / scale,
                 **vis_flips(a, b, cfg))
            for i, (a, b) in enumerate(zip(card_outs, cpu_outs))]
        worst = max(worst, err / scale)
        if not err / scale <= tol:
            raise AssertionError(
                f"video {video.video_id}: the card's mask logits differ from the CPU's by "
                f"{err / scale:.3e} of their scale (limit {tol}); clip by clip, the difference "
                f"and the hard decisions taken otherwise: {clips[video.video_id]}")
    return near, worst, clips


def vis_results_agree(got: list[dict], want: list[dict], near: dict) -> dict:
    """Two devices' YT-VIS results of the same videos (`data/ytvis.py:
    format_vis_results` entries in order; `got` the card's, `want` the
    CPU's): video ids, track order, categories and each track's count of
    non-empty frames equal, scores within `VIS_SCORE_TOL`, each frame's
    mask equal but at the pixels that `near[video_id]` ([n, K, H, W] bool,
    `data/tta.py:near_threshold` of the CPU's mask logits at the measured
    card-vs-CPU difference) excuses. Raises AssertionError; returns
    {"tracks": n, "excused": pixels that differ at near-ties}."""
    from video_knet_tpu_torch.data.rle import decode_mask

    if len(got) != len(want):
        raise AssertionError(f"{len(got)} tracks against {len(want)}")
    excused, slot = 0, {}
    for a, b in zip(got, want):
        vid = b["video_id"]
        j = slot[vid] = slot.get(vid, -1) + 1
        if (a["video_id"], a["category_id"]) != (vid, b["category_id"]):
            raise AssertionError(f"video {vid} track {j}: {a['video_id']}/{a['category_id']} "
                                 f"against {vid}/{b['category_id']}")
        if not abs(a["score"] - b["score"]) <= VIS_SCORE_TOL:
            raise AssertionError(f"video {vid} track {j}: score {a['score']} against "
                                 f"{b['score']}")
        segs = a["segmentations"], b["segmentations"]
        counts = [(len(x), sum(s is not None for s in x)) for x in segs]
        if counts[0] != counts[1]:
            raise AssertionError(f"video {vid} track {j}: (frames, non-empty frames) "
                                 f"{counts[0]} against {counts[1]}")
        hw = near[vid].shape[-2:]
        for f, (sa, sb) in enumerate(zip(*segs)):
            ma, mb = (decode_mask(s) if s is not None else np.zeros(hw, np.uint8)
                      for s in (sa, sb))
            differ = ma != mb
            if (differ & ~near[vid][f, j]).any():
                raise AssertionError(f"video {vid} track {j} frame {f}: {int(differ.sum())} "
                                     f"pixels differ, {int((differ & ~near[vid][f, j]).sum())}"
                                     " off the near-ties")
            excused += int(differ.sum())
    return {"tracks": len(got), "excused": excused}
