"""COCO-panoptic-format datasets: COCO panoptic and Cityscapes-VPS.

Counterpart of `video_knet_tpu/data/coco_panoptic.py` (the reference's
external/coco_panoptic.py CocoPanopticDatasetCustom and
external/cityscapes_vps.py CityscapesVPSDataset): a panoptic json whose
annotations carry per-image panoptic PNGs (COCO id encoding: id = R + G *
256 + B * 256^2) with segments_info (id, category_id, iscrowd).
Cityscapes-VPS groups its images into clips by file name; `get_pair` draws
a reference frame near the key inside the clip.

`load_sem_inst` gives (semantic, instance) int maps in the contiguous
things-first label space, for `data/transforms.py:pack_panoptic_gt`. The
PNGs go through the port's own codec (`data/panoptic_png.py:load_png`).
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass

import numpy as np

from video_knet_tpu_torch.data.panoptic_png import load_png


def rgb2id(color: np.ndarray) -> np.ndarray:
    """COCO panoptic PNG encoding: [H, W, 3] uint8 -> int64 segment ids."""
    c = color.astype(np.int64)
    return (c[..., 0] + 256 * c[..., 1] + 256 * 256 * c[..., 2]).astype(np.int64)


def id2rgb(ids: np.ndarray) -> np.ndarray:
    out = np.zeros((*ids.shape, 3), np.uint8)
    out[..., 0] = ids % 256
    out[..., 1] = (ids // 256) % 256
    out[..., 2] = ids // (256 * 256)
    return out


@dataclass
class PanopticSample:
    image_id: int
    img: str
    pan_png: str
    segments_info: list[dict]
    height: int
    width: int


class CocoPanopticDataset:
    """COCO-2017-panoptic-style reader.

    ann_file: panoptic json with images / annotations / categories.
    Categories go things-first into the contiguous label space (mmdet's
    coco-panoptic convention the reference keeps: 80 things, then 53
    stuff)."""

    def __init__(self, ann_file: str, img_root: str, pan_root: str):
        with open(ann_file) as f:
            data = json.load(f)
        cats = data["categories"]
        self.thing_cat_ids = [c["id"] for c in cats if c.get("isthing", 1) == 1]
        self.stuff_cat_ids = [c["id"] for c in cats if c.get("isthing", 1) == 0]
        self.cat_to_label = {
            cid: i for i, cid in enumerate(self.thing_cat_ids + self.stuff_cat_ids)
        }
        self.num_thing_classes = len(self.thing_cat_ids)
        self.num_stuff_classes = len(self.stuff_cat_ids)
        self.thing_ids_in_seg = tuple(range(self.num_thing_classes))

        anns = {a["image_id"]: a for a in data["annotations"]}
        self.samples: list[PanopticSample] = []
        for im in data["images"]:
            a = anns.get(im["id"])
            if a is None:
                continue
            self.samples.append(
                PanopticSample(
                    image_id=im["id"],
                    img=os.path.join(img_root, im["file_name"]),
                    pan_png=os.path.join(pan_root, a["file_name"]),
                    segments_info=a["segments_info"],
                    height=im["height"],
                    width=im["width"],
                )
            )

    def __len__(self):
        return len(self.samples)

    def load_sem_inst(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Panoptic PNG + segments_info -> (semantic, instance) int32 maps in
        the contiguous label space: 255 for void and unknown categories,
        instance ids 1, 2, ... for things in segments_info order, 0 for
        stuff and crowd."""
        s = self.samples[idx]
        seg_ids = rgb2id(load_png(s.pan_png))
        semantic = np.full(seg_ids.shape, 255, np.int32)
        instance = np.zeros(seg_ids.shape, np.int32)
        inst_counter = 1
        for info in s.segments_info:
            m = seg_ids == info["id"]
            label = self.cat_to_label.get(info["category_id"], 255)
            semantic[m] = label
            if label < self.num_thing_classes and not info.get("iscrowd", 0):
                instance[m] = inst_counter
                inst_counter += 1
        return semantic, instance


class CityscapesVPSDataset(CocoPanopticDataset):
    """Cityscapes-VPS: video clips with keyframes every 5 frames.

    File names follow `{clip:04d}_{frame:05d}_{city}_..._{frameid}_...png`;
    the clip id groups frames into videos. `get_pair` draws a reference
    frame at one of the `ref_range` offsets from the key inside its clip
    (the key itself where none lies inside), from `random.Random(seed)`."""

    def __init__(self, ann_file: str, img_root: str, pan_root: str,
                 ref_range: tuple[int, ...] = (-1, 1), seed: int = 0):
        super().__init__(ann_file, img_root, pan_root)
        self._rng = random.Random(seed)
        self.by_clip: dict[int, list[int]] = {}
        self.keys: list[tuple[int, int]] = []  # (clip, position)
        for i, s in enumerate(self.samples):
            base = os.path.basename(s.img)
            clip = int(base.split("_", 1)[0])
            self.by_clip.setdefault(clip, []).append(i)
        for clip, idxs in self.by_clip.items():
            idxs.sort(key=lambda i: os.path.basename(self.samples[i].img))
            for pos in range(len(idxs)):
                self.keys.append((clip, pos))
        self.ref_range = ref_range

    def get_pair(self, k: int) -> tuple[int, int]:
        clip, pos = self.keys[k]
        idxs = self.by_clip[clip]
        choices = [pos + d for d in self.ref_range if 0 <= pos + d < len(idxs)] or [pos]
        return idxs[pos], idxs[self._rng.choice(choices)]
