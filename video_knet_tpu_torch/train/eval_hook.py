"""Training-time evaluation (the reference's EvalHook / in-dataset evaluate()).

Counterpart of `video_knet_tpu/train/eval_hook.py`: `evaluate_vps` runs the
port's online inference pipeline over a val dataset and accumulates the
per-image VPQ statistics plus STQ, returning a metrics dict for logging /
best-checkpoint selection; `evaluate_image_panoptic` scores an image
K-Net's panoptic decodes per class; `format_pq_table` prints them. Host
work is numpy; the frames go to the pipeline as CPU tensors, which it moves
to its device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from video_knet_tpu_torch.data.datasets import _DVPSScan
from video_knet_tpu_torch.data.panoptic_png import decode_panoptic_ann, load_png
from video_knet_tpu_torch.data.transforms import keep_ratio_resize_pad, nearest_resize
from video_knet_tpu_torch.eval.stq import STQuality
from video_knet_tpu_torch.eval.vpq import MAX_INS, VPQStats, vpq_from_stats, vpq_stats


def evaluate_vps(
    pipeline,
    dataset: _DVPSScan,
    *,
    size_hw: tuple[int, int],
    max_frames: int | None = None,
    num_classes: int = 19,
    stats: dict | None = None,
) -> dict:
    """Returns {'PQ', 'PQ_th', 'PQ_st', 'STQ', 'AQ', 'IoU', ...} over the val
    scan. stats: optional dict, given the host seconds of the loop's parts
    ('load': frame read + resize + pad, 'decode': GT decode, 'resize':
    predictions back to the frame size, 'vpq', 'stq') summed over frames,
    and 'total', the whole call."""
    t_start = time.perf_counter()
    secs = dict.fromkeys(("load", "decode", "resize", "vpq", "stq"), 0.0)
    vpq = VPQStats(num_cat=num_classes + 1)
    stq = STQuality(
        num_classes=num_classes,
        things_list=list(dataset.thing_ids_in_seg),
        ignore_label=255,
        label_bit_shift=16,
        offset=2**25,
    )
    things = np.zeros(num_classes, bool)
    for t in dataset.thing_ids_in_seg:
        things[t] = True

    ann_mode = getattr(dataset, "ann_mode", "kitti_rgb")
    # collect scoreable frames up front (windowed run_sequence wants the flag
    # list); a skipped ann-less sequence HEAD propagates its reset to the next
    # kept frame of that sequence
    kept, flags = [], []
    pending_first = False
    for sample, is_first in dataset.iter_test():
        pending_first = pending_first or is_first
        if sample.ann is None:
            continue
        kept.append(sample)
        flags.append(pending_first)
        pending_first = False
        if max_frames is not None and len(kept) >= max_frames:
            break

    meta: list = []

    def frames():
        for sample in kept:
            t0 = time.perf_counter()
            rgb = load_png(sample.img)
            # keep-ratio resize + pad (the reference's test pipeline), then
            # crop predictions back to the content region before rescaling
            x, content_hw = keep_ratio_resize_pad(rgb, size_hw)
            meta.append((rgb.shape[:2], content_hw))
            secs["load"] += time.perf_counter() - t0
            yield torch.from_numpy(x)[None]

    n = 0
    for i, res in enumerate(pipeline.run_sequence(frames(), flags)):
        sample = kept[i]
        ori_hw, (ch, cw) = meta[i]
        t0 = time.perf_counter()
        sem = nearest_resize(
            res.semantic_map.astype(np.int64)[:ch, :cw], ori_hw)
        trk = nearest_resize(
            res.track_map.astype(np.int64)[:ch, :cw], ori_hw)
        t1 = time.perf_counter()
        gt_sem, gt_inst = decode_panoptic_ann(sample.ann, ann_mode)
        t2 = time.perf_counter()
        pred_pan = sem * MAX_INS + trk
        gt_pan = gt_sem.astype(np.int64) * MAX_INS + gt_inst.astype(np.int64)
        vpq += vpq_stats(pred_pan, gt_pan, num_cat=num_classes + 1)
        t3 = time.perf_counter()
        stq.update_state(
            (gt_sem.astype(np.int64) << 16) + gt_inst.astype(np.int64),
            (sem << 16) + trk,
            sequence_id=sample.seq_id,
        )
        t4 = time.perf_counter()
        for key, dt in (("resize", t1 - t0), ("decode", t2 - t1), ("vpq", t3 - t2),
                        ("stq", t4 - t3)):
            secs[key] += dt
        n += 1

    out = vpq_from_stats(vpq, num_classes=num_classes, things_index=things)
    r = stq.result()
    out.update({"STQ": r["STQ"], "AQ": r["AQ"], "IoU": r["IoU"], "frames": n})
    if stats is not None:
        stats.update(secs, total=time.perf_counter() - t_start)
    return out


def evaluate_image_panoptic(
    decode_fn,
    samples,
    *,
    size_hw: tuple[int, int],
    thing_ids_in_seg,
    num_classes: int,
    ann_mode: str = "kitti_rgb",
    max_images: int | None = None,
    class_names=None,
) -> dict:
    """Image-K-Net panoptic evaluation: per-class PQ/SQ/RQ over a val set.

    The in-dataset evaluate() of the reference (image-level PQ via
    vpq_eval), the phase-1 quality gate of the two-phase workflow.

    decode_fn(img [1, H, W, 3] float32 CPU tensor) -> (pan [H, W] numpy,
    segments_info); samples: iterable with .img / .ann paths (e.g.
    _DVPSScan frames).
    """
    from video_knet_tpu_torch.models.video.inference import semantic_map_from_panoptic

    stats = VPQStats(num_cat=num_classes + 1)
    things = np.zeros(num_classes, bool)
    for t in thing_ids_in_seg:
        things[t] = True
    nt = len(tuple(thing_ids_in_seg))
    # KITTI/cityscapes-style label spaces need the thing->orig index mapping;
    # a things-first space (VIP-Seg) is the identity (None)
    ids = tuple(thing_ids_in_seg)
    thing_ids_in_orig = None if ids == tuple(range(nt)) else ids

    n = 0
    for sample in samples:
        if sample.ann is None:
            continue
        rgb = load_png(sample.img)
        ori_hw = rgb.shape[:2]
        x, (ch, cw) = keep_ratio_resize_pad(rgb, size_hw)
        pan, infos = decode_fn(torch.from_numpy(x)[None])
        pan = nearest_resize(np.asarray(pan)[:ch, :cw], ori_hw)
        sem = semantic_map_from_panoptic(
            pan, infos,
            num_thing_classes=nt,
            num_stuff_classes=num_classes - nt,
            thing_ids_in_orig=thing_ids_in_orig,
        )
        inst = np.zeros(pan.shape, np.int64)
        tid = 0
        for info in infos:
            if info["isthing"]:
                tid += 1
                inst[pan == info["id"]] = tid
        gt_sem, gt_inst = decode_panoptic_ann(sample.ann, ann_mode)
        pred_pan = sem.astype(np.int64) * MAX_INS + inst
        gt_pan = gt_sem.astype(np.int64) * MAX_INS + gt_inst.astype(np.int64)
        stats += vpq_stats(pred_pan, gt_pan, num_cat=num_classes + 1)
        n += 1
        if max_images is not None and n >= max_images:
            break

    out = vpq_from_stats(stats, num_classes=num_classes, things_index=things)
    out["images"] = n
    if class_names is not None:
        out["table"] = format_pq_table(out, class_names)
    return out


def format_pq_table(res: dict, class_names) -> str:
    """Per-class PQ/SQ/RQ table (the reference's kitti_step_dvps.py:303-318)."""
    lines = [f"{'class':<16}{'PQ':>8}{'SQ':>8}{'RQ':>8}"]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name:<16}{res['PQ_per_class'][i]:>8.1f}"
            f"{res['SQ_per_class'][i]:>8.1f}{res['RQ_per_class'][i]:>8.1f}"
        )
    lines.append(
        f"{'ALL':<16}{res['PQ']:>8.1f}{res['SQ']:>8.1f}{res['RQ']:>8.1f}"
    )
    return "\n".join(lines)
