"""COCO instance-segmentation results: the per-class lists and the results
JSON.

Counterpart of `video_knet_tpu/eval/coco_instance.py`: `segm2result` (the
reference's `knet/det/kernel_update_head.py:470-483`) groups the
thresholded masks and score-only "fake" boxes by class; mmdet's
`segm2json` form turns one image's detections into COCO `segm` entries
(RLE masks, category ids through the dataset's `cat_ids`). Inputs are
numpy arrays or tensors (moved to the host).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from video_knet_tpu_torch.data.rle import encode_mask


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def segm2result(mask_probs, labels, scores, *, num_classes: int, mask_thr: float = 0.5,
                score_thr: float = 0.0) -> tuple[list[np.ndarray], list[list[np.ndarray]]]:
    """(bbox_result, segm_result) by class from mask_probs [K, H, W], labels
    [K], scores [K]. A box row is zeros with the score last; detections
    below `score_thr` are dropped (0.0 keeps all, as the reference)."""
    labels, scores = _host(labels), _host(scores)
    seg_masks = _host(mask_probs) > mask_thr
    keep = scores >= score_thr
    bbox_result = []
    segm_result: list[list[np.ndarray]] = [[] for _ in range(num_classes)]
    for cls in range(num_classes):
        sel = keep & (labels == cls)
        boxes = np.zeros((int(sel.sum()), 5), np.float32)
        boxes[:, -1] = scores[sel]
        bbox_result.append(boxes)
    for idx in np.nonzero(keep)[0]:
        segm_result[int(labels[idx])].append(seg_masks[idx])
    return bbox_result, segm_result


def instances_to_coco_json(image_id: int, mask_probs, labels, scores, cat_ids: list[int], *,
                           mask_thr: float = 0.5, score_thr: float = 0.0) -> list[dict]:
    """One image's detections -> COCO `segm` result entries (RLE counts
    strings, `data/rle.py`; the mask's tight box as [x, y, w, h])."""
    labels, scores = _host(labels), _host(scores)
    seg_masks = _host(mask_probs) > mask_thr
    out = []
    for k in range(len(scores)):
        if scores[k] < score_thr:
            continue
        m = seg_masks[k]
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            bbox = [0.0, 0.0, 0.0, 0.0]
        else:
            x0, y0 = float(xs.min()), float(ys.min())
            bbox = [x0, y0, float(xs.max()) - x0 + 1, float(ys.max()) - y0 + 1]
        out.append({
            "image_id": int(image_id),
            "category_id": int(cat_ids[int(labels[k])]),
            "segmentation": encode_mask(m),
            "bbox": bbox,
            "score": float(scores[k]),
        })
    return out


def write_coco_results(results: list[dict], out_dir: str) -> str:
    """Write the results list as <out_dir>/coco_segm.json; returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "coco_segm.json")

    def default(o):
        if isinstance(o, bytes):
            return o.decode("ascii")
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(results, f, default=default)
    return path
