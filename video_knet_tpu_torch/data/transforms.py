"""Host-side (numpy) per-sample transforms with frame-shared parameters.

Counterpart of `video_knet_tpu/data/transforms.py`, the same numpy
arithmetic, so every array is bit-equal to JAX's. The reference's Seq* DVPS
pipeline: keep-ratio resize with a random ratio from `ratio_range`, shared
horizontal flip, shared random crop to a fixed (H, W), mean/std
normalization, and pad-to-crop-size. The output shape is always exactly
`crop_size` (crop + bottom/right zero-pad), so every train batch has one
shape.

`pack_panoptic_gt` converts (semantic, instance) label maps into the
fixed-slot `PanopticGT` of numpy arrays (thing instances via the dataset's
thing id list, the reference's `cherry` pick, and per-stuff-class masks via
its sem2ins_masks logic), bilinear-downsampled to the mask-assign stride
like the reference's KNet.forward_train. `nearest_resize` is also the
serving pipeline's host upsample (`models/video/inference.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from video_knet_tpu_torch.ops.targets import PanopticGT

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def bilinear_resize(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """align_corners=False bilinear resize on the leading two axes of [H, W, ...]."""
    h, w = arr.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return arr.astype(np.float32)
    ys = (np.arange(oh) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    a = arr.astype(np.float32)
    top = a[y0][:, x0] * (1 - wx)[None, :, None] + a[y0][:, x1] * wx[None, :, None] \
        if a.ndim == 3 else a[y0][:, x0] * (1 - wx)[None, :] + a[y0][:, x1] * wx[None, :]
    bot = a[y1][:, x0] * (1 - wx)[None, :, None] + a[y1][:, x1] * wx[None, :, None] \
        if a.ndim == 3 else a[y1][:, x0] * (1 - wx)[None, :] + a[y1][:, x1] * wx[None, :]
    wy_b = wy[:, None, None] if a.ndim == 3 else wy[:, None]
    return top * (1 - wy_b) + bot * wy_b


def nearest_resize(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Nearest resize of a [H, W, ...] array (half-pixel centers)."""
    h, w = arr.shape[:2]
    oh, ow = out_hw
    ys = np.clip(((np.arange(oh) + 0.5) * (h / oh)).astype(np.int64), 0, h - 1)
    xs = np.clip(((np.arange(ow) + 0.5) * (w / ow)).astype(np.int64), 0, w - 1)
    return arr[ys][:, xs]


@dataclass(frozen=True)
class SeqTransformParams:
    """One draw of the frame-shared augmentation parameters."""

    scale: float  # resize ratio applied to the base scale
    flip: bool
    crop_y: float  # in [0, 1): relative crop offsets
    crop_x: float
    # base img_scale the ratio multiplies (mmcv Resize(img_scale, ratio_range,
    # keep_ratio=True) semantics): the actual resize factor becomes
    # min(max(img_scale)*r/max(in_hw), min(img_scale)*r/min(in_hw)).
    # None keeps the raw-input-relative behavior (factor = r).
    img_scale: tuple[int, int] | None = None


def sample_transform_params(
    rng: np.random.RandomState,
    *,
    ratio_range: tuple[float, float] = (0.5, 2.0),
    flip_prob: float = 0.5,
    img_scale: tuple[int, int] | None = None,
) -> SeqTransformParams:
    return SeqTransformParams(
        scale=float(rng.uniform(*ratio_range)),
        flip=bool(rng.rand() < flip_prob),
        crop_y=float(rng.rand()),
        crop_x=float(rng.rand()),
        img_scale=img_scale,
    )


def _resolve_geometry(
    in_hw: tuple[int, int], crop_hw: tuple[int, int], p: SeqTransformParams
) -> tuple[tuple[int, int], tuple[int, int]]:
    """Returns (resized_hw, crop_offset_yx)."""
    f = p.scale
    if p.img_scale is not None:
        f = min(
            max(p.img_scale) * p.scale / max(in_hw),
            min(p.img_scale) * p.scale / min(in_hw),
        )
    rh = max(1, int(round(in_hw[0] * f)))
    rw = max(1, int(round(in_hw[1] * f)))
    off_y = int(p.crop_y * max(rh - crop_hw[0], 0) + 0.5) if rh > crop_hw[0] else 0
    off_x = int(p.crop_x * max(rw - crop_hw[1], 0) + 0.5) if rw > crop_hw[1] else 0
    return (rh, rw), (off_y, off_x)


def keep_ratio_resize_pad(
    img: np.ndarray,
    target_hw: tuple[int, int],
    *,
    mean: np.ndarray | None = IMAGENET_MEAN,
    std: np.ndarray | None = IMAGENET_STD,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Test-time keep-ratio resize into a fixed canvas (the reference's
    keep_ratio Resize + Pad, vs. aspect-distorting direct resize).

    Resizes by min(th/h, tw/w), normalizes, zero-pads bottom/right to
    target_hw (zero = mean after normalization, matching Pad-after-Normalize).
    Returns (canvas [th, tw, C], content_hw) — crop predictions back to
    content_hw before rescaling to the original resolution.
    """
    h, w = img.shape[:2]
    th, tw = target_hw
    f = min(th / h, tw / w)
    ch = min(th, max(1, int(round(h * f))))
    cw = min(tw, max(1, int(round(w * f))))
    x = bilinear_resize(img, (ch, cw))
    if mean is not None:
        x = (x - mean) / std
    out = np.zeros((th, tw) + img.shape[2:], np.float32)
    out[:ch, :cw] = x
    return out, (ch, cw)


def apply_image_transform(
    img: np.ndarray,
    p: SeqTransformParams,
    crop_hw: tuple[int, int],
    *,
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> normalized float32 [crop_H, crop_W, 3]."""
    (rh, rw), (oy, ox) = _resolve_geometry(img.shape[:2], crop_hw, p)
    x = bilinear_resize(img, (rh, rw))
    if p.flip:
        x = x[:, ::-1]
    x = x[oy : oy + crop_hw[0], ox : ox + crop_hw[1]]
    x = (x - mean) / std
    out = np.zeros((*crop_hw, 3), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def apply_mask_transform(
    labels: np.ndarray,
    p: SeqTransformParams,
    crop_hw: tuple[int, int],
    *,
    pad_value: int = 255,
) -> np.ndarray:
    """int label map [H, W] -> [crop_H, crop_W] (nearest resize, pad with 255)."""
    (rh, rw), (oy, ox) = _resolve_geometry(labels.shape[:2], crop_hw, p)
    x = nearest_resize(labels, (rh, rw))
    if p.flip:
        x = x[:, ::-1]
    x = x[oy : oy + crop_hw[0], ox : ox + crop_hw[1]]
    out = np.full(crop_hw, pad_value, labels.dtype)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def pack_panoptic_gt(
    semantic: np.ndarray,
    instance: np.ndarray,
    *,
    thing_ids_in_seg: Sequence[int],
    num_stuff_classes: int,
    max_insts: int,
    assign_stride: int,
    ignore_label: int = 255,
) -> PanopticGT:
    """(semantic, instance) full-res maps -> fixed-slot PanopticGT (numpy arrays).

    Thing instances: unique (thing class, instance) pairs; label = index into
    `thing_ids_in_seg` (the cherry mapping); instance_id = semantic * 1e4 + inst
    (globally unique within a frame pair). Stuff: one slot per stuff class in
    sem2ins_masks_kitti_step order (original semantic order, thing ids skipped).
    Masks are bilinear-downsampled to assign_stride like the reference.
    """
    h, w = semantic.shape
    ah, aw = h // assign_stride, w // assign_stride
    thing_set = list(thing_ids_in_seg)

    masks = np.zeros((max_insts, ah, aw), np.float32)
    labels = np.zeros((max_insts,), np.int32)
    valid = np.zeros((max_insts,), bool)
    inst_ids = np.full((max_insts,), -1, np.int32)

    slot = 0
    pan = semantic.astype(np.int64) * 10000 + instance.astype(np.int64)
    for pid in np.unique(pan):
        cls = int(pid // 10000)
        if cls not in thing_set:
            continue
        if slot >= max_insts:
            break
        m = (pan == pid).astype(np.float32)
        masks[slot] = bilinear_resize(m, (ah, aw))
        labels[slot] = thing_set.index(cls)
        inst_ids[slot] = int(pid % (2**31))
        valid[slot] = True
        slot += 1

    sem_masks = np.zeros((num_stuff_classes, ah, aw), np.float32)
    sem_valid = np.zeros((num_stuff_classes,), bool)
    stuff_slot = 0
    total_classes = len(thing_set) + num_stuff_classes
    for cls in range(total_classes):
        if cls in thing_set:
            continue
        m = semantic == cls
        if m.any():
            sem_masks[stuff_slot] = bilinear_resize(m.astype(np.float32), (ah, aw))
            sem_valid[stuff_slot] = True
        stuff_slot += 1

    return PanopticGT(
        masks=masks,
        labels=labels,
        valid=valid,
        instance_ids=inst_ids,
        sem_masks=sem_masks,
        sem_valid=sem_valid,
    )
