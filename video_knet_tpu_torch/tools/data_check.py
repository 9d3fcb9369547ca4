"""A seeded KITTI-STEP tree for the data path's checks, written with the
port's own PNG writer (no PIL), so it runs wherever the port runs: the CPU
tests at small sizes and `chip_smoke.py` on the card at the raw KITTI-STEP
frame size (375x1242).

`write_kitti_step_tree` writes `video_sequence/{split}` with
`{seq:06d}_{frame:06d}_leftImg8bit.png` RGB frames and `_panoptic.png` GT in
the `kitti_rgb` encoding (R = class, G * 256 + B = instance id): 12 of
KITTI-STEP's 17 stuff classes in horizontal bands (sky on top, road at the
bottom), a void patch, and `n_things` person (11) / car (13) boxes that
overlap and move from frame to frame with persistent ids (some above 255,
so G is used). Frames are the bands' colours with the boxes' over them and
seeded noise, which compresses about as a camera frame does.

`write_semkitti_tree` writes the same scene in SemKITTI-DVPS's layout
(`_gtFine_class.png` + `_gtFine_instance.png` and a uint16 `_depth.png` in
metres * 256), its things drawn from SemKITTI's eight thing classes (11-18);
`write_coco_images` writes seeded PNG images and a COCO image list.
"""

from __future__ import annotations

import os

import numpy as np

STUFF_BANDS = (10, 2, 8, 1, 5, 6, 7, 3, 4, 9, 12, 0)  # top to bottom
THING_CLASSES = (11, 13)


def write_kitti_step_tree(root: str, *, n_seqs: int = 2, n_frames: int = 6,
                          hw: tuple[int, int] = (375, 1242), n_things: int = 15,
                          split: str = "train", seed: int = 0,
                          no_ann: tuple = ()) -> dict[str, np.ndarray]:
    """Write the tree under `root`; (seq, frame) pairs in `no_ann` get no GT
    file. Returns {path: the array written}."""
    from video_knet_tpu_torch.data.panoptic_png import save_png

    d = os.path.join(root, "video_sequence", split)
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    palette = rng.randint(0, 256, (256, 3))
    written = {}
    for s in range(n_seqs):
        cuts = np.sort(rng.randint(1, h, len(STUFF_BANDS) - 1))  # some bands empty at small h
        band_cls = np.zeros(h, np.uint8)
        for cls, (y0, y1) in zip(STUFF_BANDS, zip((0, *cuts), (*cuts, h))):
            band_cls[y0:y1] = cls
        bh = rng.randint(max(2, h // 10), max(3, h // 3), n_things)
        bw = rng.randint(max(2, w // 20), max(3, w // 6), n_things)
        y0s = rng.randint(0, h - bh + 1)
        x0s = rng.randint(0, w - bw + 1)
        dx = rng.randint(-(w // 60) - 1, w // 60 + 2, n_things)
        cls_of = np.array(THING_CLASSES)[rng.randint(0, 2, n_things)]
        ids = 1 + np.arange(n_things) * 37  # persistent; above 255 from the 8th
        for f in range(n_frames):
            pan = np.zeros((h, w, 3), np.uint8)
            pan[..., 0] = band_cls[:, None]
            pan[: max(1, h // 20), : max(1, w // 30), 0] = 255  # void
            for k in range(n_things):
                x0 = int(np.clip(x0s[k] + dx[k] * f, 0, w - bw[k]))
                box = pan[y0s[k]:y0s[k] + bh[k], x0:x0 + bw[k]]
                box[...] = (cls_of[k], ids[k] // 256, ids[k] % 256)
            cls_map = pan[..., 0].astype(np.int64)
            key = cls_map * 7 + pan[..., 2]
            img = palette[key % 256] + rng.randint(-12, 13, (h, w, 3))
            img = np.clip(img, 0, 255).astype(np.uint8)
            stem = os.path.join(d, f"{s:06d}_{f:06d}_")
            save_png(stem + "leftImg8bit.png", img)
            written[stem + "leftImg8bit.png"] = img
            if (s, f) not in no_ann:
                save_png(stem + "panoptic.png", pan)
                written[stem + "panoptic.png"] = pan
    return written


def write_semkitti_tree(root: str, *, n_frames: int = 4, hw: tuple[int, int] = (375, 1242),
                        split: str = "val", seed: int = 0) -> str:
    """One SemKITTI-DVPS sequence under `root`: `write_kitti_step_tree`'s
    scene (things relabelled into 11-18), the class and instance maps as
    separate PNGs, and depth 2-90 m as uint16 metres * 256."""
    from video_knet_tpu_torch.data.panoptic_png import decode_kitti_panoptic, save_png

    written = write_kitti_step_tree(root, n_seqs=1, n_frames=n_frames, hw=hw, split=split,
                                    seed=seed)
    rng = np.random.RandomState(seed + 1)
    remap = np.arange(256)
    remap[list(THING_CLASSES)] = (11, 15)  # person, car -> two of SemKITTI's things
    for path, pan in written.items():
        if not path.endswith("panoptic.png"):
            continue
        sem, inst = decode_kitti_panoptic(pan)
        stem = path[: -len("panoptic.png")]
        save_png(stem + "gtFine_class.png", remap[sem].astype(np.uint8))
        save_png(stem + "gtFine_instance.png", inst.astype(np.uint16))
        save_png(stem + "depth.png", (rng.uniform(2, 90, sem.shape) * 256).astype(np.uint16))
        os.remove(path)
    return root


def write_coco_images(root: str, *, n: int = 2, hw: tuple[int, int] = (480, 640),
                      seed: int = 0) -> str:
    """`n` seeded PNG images of coloured boxes on noise and their COCO image
    list (`ann.json`, no categories: the preset's 80 classes); returns the
    list's path."""
    import json

    from video_knet_tpu_torch.data.panoptic_png import save_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    images = []
    for i in range(n):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8) // 4 + 64
        for _ in range(6):
            bh, bw = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
            y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
            img[y:y + bh, x:x + bw] = rng.randint(0, 256, 3)
        save_png(os.path.join(root, f"{i:06d}.png"), img)
        images.append({"id": i + 1, "file_name": f"{i:06d}.png", "height": h, "width": w})
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": [], "categories": []}, f)
    return ann
