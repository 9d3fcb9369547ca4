"""Forecasting data pipelines: instance-map annotation loading and padding.

Counterpart of `video_knet_tpu/data/forecasting.py`, which rebuilds the
reference's external/dataset/forecasting_pipelines/{loading,transforms}.py
(its panoptic-forecasting experiments; no release config uses them) as
numpy functions instead of mmcv PIPELINES classes:

- `load_instance_annotations`: LoadAnnotationsInstanceMasks. A
  Cityscapes-style instance map encodes things as id >= 10000 with class
  id // 1000; per-instance binary masks, labels and boxes, and optionally
  the id map with the stuff ids (< 10000) scaled by 1000.
- `bitmasks_to_boxes`: bitmasks2bboxes. The reference keeps the INCLUSIVE
  max pixel index as x2 / y2 (no +1); kept.
- `pad_to`: PadFutureMMDet, fixed-size / divisor / square padding of the
  image, masks and segmentation with a pad value each.
- `normalize_multiple`: NormalizeMultiple.
- `knet_ins_adapter`: KNetInsAdapter, Cityscapes-style thing labels from 11
  to 0-based.
"""

from __future__ import annotations

import numpy as np

THING_ID_BASE = 10000  # ids >= 10000 are instances
LABEL_DIV = 1000


def bitmasks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] binary -> [N, 4] float32 boxes (x1, y1, x2, y2) with the
    INCLUSIVE max coordinates; an empty mask gives zeros."""
    n = masks.shape[0]
    boxes = np.zeros((n, 4), np.float32)
    x_any = np.any(masks, axis=1)
    y_any = np.any(masks, axis=2)
    for i in range(n):
        xs = np.where(x_any[i])[0]
        ys = np.where(y_any[i])[0]
        if len(xs) > 0 and len(ys) > 0:
            boxes[i] = (xs[0], ys[0], xs[-1], ys[-1])
    return boxes


def load_instance_annotations(
    inst_map: np.ndarray,
    *,
    with_mask: bool = True,
    with_inst: bool = False,
    semantic_seg: np.ndarray | None = None,
) -> dict | None:
    """LoadAnnotationsInstanceMasks on a decoded instance map. None when
    `with_mask` and the map holds no instance (the reference drops the
    sample)."""
    out: dict = {}
    if with_inst:
        gim = inst_map.astype(np.int64).copy()
        gim[inst_map < THING_ID_BASE] *= LABEL_DIV
        out["gt_instance_map"] = gim
    if with_mask:
        masks, labels = [], []
        for inst_id in np.unique(inst_map):
            if inst_id >= THING_ID_BASE:
                masks.append((inst_map == inst_id).astype(np.int64))
                labels.append(int(inst_id) // LABEL_DIV)
        if not masks:
            return None
        gt_masks = np.stack(masks)
        out["gt_masks"] = gt_masks
        out["gt_labels"] = np.asarray(labels)
        out["gt_bboxes"] = bitmasks_to_boxes(gt_masks)
    if semantic_seg is not None:
        out["gt_semantic_seg"] = semantic_seg
    return out


def _pad_2d(arr: np.ndarray, shape: tuple[int, int], val) -> np.ndarray:
    ph = max(0, shape[0] - arr.shape[0])
    pw = max(0, shape[1] - arr.shape[1])
    widths = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, widths, constant_values=val)


def pad_to(
    img: np.ndarray,
    *,
    size: tuple[int, int] | None = None,
    size_divisor: int | None = None,
    pad_to_square: bool = False,
    masks: np.ndarray | None = None,
    seg: np.ndarray | None = None,
    pad_val: dict | None = None,
) -> dict:
    """PadFutureMMDet: exactly one of `size`, `size_divisor` and
    `pad_to_square`; masks pad with their own value (0) and seg with 255 by
    default."""
    pv = {"img": 0, "masks": 0, "seg": 255}
    pv.update(pad_val or {})
    if pad_to_square:
        if size is not None or size_divisor is not None:
            raise ValueError("size/size_divisor must be None for pad_to_square")
        m = max(img.shape[:2])
        size = (m, m)
    elif (size is None) == (size_divisor is None):
        raise ValueError("exactly one of size and size_divisor must be set")
    if size is None:
        d = size_divisor
        size = (int(np.ceil(img.shape[0] / d)) * d,
                int(np.ceil(img.shape[1] / d)) * d)
    out = {
        "img": _pad_2d(img, size, pv["img"]),
        "pad_shape": size,
        "pad_fixed_size": None if size_divisor else size,
        "pad_size_divisor": size_divisor,
    }
    if masks is not None:
        out["masks"] = np.stack(
            [_pad_2d(m, size, pv["masks"]) for m in masks]
        ) if len(masks) else masks
    if seg is not None:
        out["seg"] = _pad_2d(seg, size, pv["seg"])
    return out


def normalize_multiple(
    imgs: list[np.ndarray],
    mean,
    std,
    to_rgb: bool = True,
) -> list[np.ndarray]:
    """NormalizeMultiple: (x[, BGR -> RGB] - mean) / std of each image, in
    float32."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = []
    for im in imgs:
        x = im.astype(np.float32)
        if to_rgb:
            x = x[..., ::-1]
        out.append((x - mean) / std)
    return out


def knet_ins_adapter(labels: np.ndarray, stuff_nums: int = 11) -> np.ndarray:
    """KNetInsAdapter: Cityscapes-style thing class ids (from `stuff_nums`)
    -> 0-based."""
    return labels - stuff_nums
