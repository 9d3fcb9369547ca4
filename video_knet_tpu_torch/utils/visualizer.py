"""Colorization and drawing for qualitative dumps.

Counterpart of `video_knet_tpu/utils/visualizer.py` (the reference's
scripts/visualizer.py: id2rgb hash colors, the Cityscapes palette,
trackmap2rgb). A track's color comes from a hash of its id, so it keeps
its color across frames and runs. numpy only; the results are those of the
JAX package bit for bit.
"""

from __future__ import annotations

import hashlib

import numpy as np

CITYSCAPES_PALETTE = np.array(
    [
        (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
        (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
        (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
        (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
        (0, 0, 230), (119, 11, 32),
    ],
    np.uint8,
)


def id2rgb(idx: int) -> tuple[int, int, int]:
    """The hash color of a track or segment id: the first three bytes of
    sha256(str(id)); id 0 is black."""
    if idx == 0:
        return (0, 0, 0)
    digest = hashlib.sha256(str(int(idx)).encode()).digest()
    return (digest[0], digest[1], digest[2])


def trackmap2rgb(track_map: np.ndarray) -> np.ndarray:
    """[H, W] int track-id map -> [H, W, 3] uint8."""
    out = np.zeros((*track_map.shape, 3), np.uint8)
    for tid in np.unique(track_map):
        out[track_map == tid] = id2rgb(int(tid))
    return out


def cat2rgb(cat_map: np.ndarray, palette: np.ndarray = CITYSCAPES_PALETTE) -> np.ndarray:
    """[H, W] semantic map -> RGB through a class palette; 255 and any class
    past the palette are black."""
    out = np.zeros((*cat_map.shape, 3), np.uint8)
    valid = cat_map < len(palette)
    out[valid] = palette[cat_map[valid]]
    return out


def overlay(img: np.ndarray, color_map: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """An RGB color map blended over an RGB image where it is not black."""
    img = img.astype(np.float32)
    cm = color_map.astype(np.float32)
    blend = np.where(cm.sum(-1, keepdims=True) > 0, (1 - alpha) * img + alpha * cm, img)
    return blend.astype(np.uint8)


def draw_boxes(img: np.ndarray, boxes: np.ndarray, ids: np.ndarray | None = None,
               thickness: int = 2) -> np.ndarray:
    """xyxy boxes drawn in their track id's color (box i + 1 without ids)."""
    out = img.copy()
    h, w = img.shape[:2]
    for i, box in enumerate(boxes):
        x0, y0, x1, y1 = [int(v) for v in box]
        x0, x1 = np.clip([x0, x1], 0, w - 1)
        y0, y1 = np.clip([y0, y1], 0, h - 1)
        color = id2rgb(int(ids[i]) if ids is not None else i + 1)
        out[y0:y0 + thickness, x0:x1] = color
        out[max(y1 - thickness, 0):y1, x0:x1] = color
        out[y0:y1, x0:x0 + thickness] = color
        out[y0:y1, max(x1 - thickness, 0):x1] = color
    return out
