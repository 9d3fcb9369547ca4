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
`write_cityscapes_step_tree` writes the same scene as a Cityscapes-STEP
image tree (`leftImg8bit/` + `panoptic/`, a directory a city).
`write_kitti_step_raw` writes it in raw KITTI-STEP's layout
(`images/{seq:04d}/{frame:06d}.png` and `panoptic/...`), what
`tools/kitti_step_prepare.py` turns into the tree above.

`write_semkitti_tree` writes the same scene in SemKITTI-DVPS's layout
(`_gtFine_class.png` + `_gtFine_instance.png` and a uint16 `_depth.png` in
metres * 256), its things drawn from SemKITTI's eight thing classes (11-18);
`write_coco_images` writes seeded PNG images and a COCO image list.

`write_ytvis_tree` writes a raw YouTube-VIS json (`videos[].file_names`,
per-instance `segmentations` / `bboxes` / `areas` a frame, null where the
instance is absent) over PNG frames, its instances' masks as raw-count
RLEs, compressed-string RLEs and polygons in turn;
`write_coco_panoptic_tree` a COCO panoptic json over PNG images and
panoptic PNGs (stuff bands, thing boxes, a crowd segment, a segment of an
unknown category, void); `write_cityscapes_vps_tree` the same scene under
Cityscapes-VPS's `{clip:04d}_{frame:05d}_...` names and its 19 classes.
"""

from __future__ import annotations

import os

import numpy as np

STUFF_BANDS = (10, 2, 8, 1, 5, 6, 7, 3, 4, 9, 12, 0)  # top to bottom
THING_CLASSES = (11, 13)


def _sequence(rng: np.random.RandomState, palette: np.ndarray, hw: tuple[int, int],
              n_things: int, n_frames: int):
    """One sequence's frames: yields (frame index, RGB image, kitti_rgb
    panoptic GT)."""
    h, w = hw
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
        yield f, np.clip(img, 0, 255).astype(np.uint8), pan


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
    palette = rng.randint(0, 256, (256, 3))
    written = {}
    for s in range(n_seqs):
        for f, img, pan in _sequence(rng, palette, hw, n_things, n_frames):
            stem = os.path.join(d, f"{s:06d}_{f:06d}_")
            save_png(stem + "leftImg8bit.png", img)
            written[stem + "leftImg8bit.png"] = img
            if (s, f) not in no_ann:
                save_png(stem + "panoptic.png", pan)
                written[stem + "panoptic.png"] = pan
    return written


def write_kitti_step_raw(root: str, *, seqs: tuple = (0, 1, 2), n_frames: int = 6,
                         hw: tuple[int, int] = (375, 1242), n_things: int = 15,
                         seed: int = 0, no_ann: tuple = ()) -> tuple[str, str]:
    """Raw KITTI-STEP under `root`, `write_kitti_step_tree`'s frames and
    kitti_rgb GT: `images/{seq:04d}/{frame:06d}.png` and
    `panoptic/{seq:04d}/{frame:06d}.png` for each sequence number in `seqs`
    (its STEP split follows from the number); (seq, frame) pairs in `no_ann`
    get no GT file. Returns (the images directory, the panoptic directory)."""
    from video_knet_tpu_torch.data.panoptic_png import save_png

    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 256, (256, 3))
    dirs = tuple(os.path.join(root, kind) for kind in ("images", "panoptic"))
    for s in seqs:
        for d in dirs:
            os.makedirs(os.path.join(d, f"{s:04d}"), exist_ok=True)
        for f, img, pan in _sequence(rng, palette, hw, n_things, n_frames):
            save_png(os.path.join(dirs[0], f"{s:04d}", f"{f:06d}.png"), img)
            if (s, f) not in no_ann:
                save_png(os.path.join(dirs[1], f"{s:04d}", f"{f:06d}.png"), pan)
    return dirs


def write_cityscapes_step_tree(root: str, *, cities: tuple = ("aachen", "bremen"),
                               n_images: int = 2, hw: tuple[int, int] = (1024, 2048),
                               n_things: int = 15, split: str = "train",
                               seed: int = 0) -> dict[str, np.ndarray]:
    """A Cityscapes-STEP tree as `data/datasets.py:CityscapesSTEPImages`
    reads it: `leftImg8bit/{split}/{city}/{city}_{i:06d}_000019_leftImg8bit.png`
    and its `panoptic/{split}/{city}/..._panoptic.png` (kitti_rgb GT, the
    19-class space), `n_images` frames of `write_kitti_step_tree`'s scene a
    city. Returns {path: the array written}."""
    from video_knet_tpu_torch.data.panoptic_png import save_png

    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 256, (256, 3))
    written = {}
    for city in cities:
        dirs = [os.path.join(root, kind, split, city) for kind in ("leftImg8bit", "panoptic")]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        for f, img, pan in _sequence(rng, palette, hw, n_things, n_images):
            stem = f"{city}_{f:06d}_000019_"
            for d, kind, arr in zip(dirs, ("leftImg8bit", "panoptic"), (img, pan)):
                path = os.path.join(d, stem + kind + ".png")
                save_png(path, arr)
                written[path] = arr
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


YTVIS_NUM_CATEGORIES = 40  # YouTube-VIS 2019's category ids 1..40


def _ellipse(hw: tuple[int, int], cy: float, cx: float, ry: float, rx: float) -> np.ndarray:
    yy, xx = np.ogrid[: hw[0], : hw[1]]
    return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0).astype(np.uint8)


def _bbox(mask: np.ndarray) -> list[float]:
    ys, xs = np.nonzero(mask)
    return [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
            float(ys.max() - ys.min() + 1)]


def _instance_frame(it: dict, f: int, hw: tuple[int, int]) -> tuple[np.ndarray, object]:
    """(mask, segmentation) of a `write_ytvis_tree` instance in frame `f`:
    its polygon (kind 2) or its ellipse as a raw-count (kind 0) or
    compressed-string (kind 1) RLE, moved `f` steps."""
    from video_knet_tpu_torch.data.polygon import polygons_to_mask
    from video_knet_tpu_torch.data.rle import counts_to_string, mask_to_counts

    h, w = hw
    cy, cx = it["cy"] + it["vy"] * f, it["cx"] + it["vx"] * f
    if it["kind"] == 2:
        r = it["radii"][: len(it["angles"])]
        xs = np.clip(cx + it["rx"] * r * np.cos(it["angles"]), 0, w - 1)
        ys = np.clip(cy + it["ry"] * r * np.sin(it["angles"]), 0, h - 1)
        poly = [round(float(c), 2) for xy in zip(xs, ys) for c in xy]
        return polygons_to_mask([poly], h, w), [poly]
    mask = _ellipse(hw, cy, cx, it["ry"], it["rx"])
    counts = mask_to_counts(mask)
    return mask, {"size": [h, w], "counts": [int(c) for c in counts] if it["kind"] == 0
                  else counts_to_string(counts)}


def write_ytvis_tree(root: str, *, n_videos: int = 8, n_frames: int = 8,
                     hw: tuple[int, int] = (720, 1280), max_insts: int = 3,
                     seed: int = 0) -> tuple[str, str]:
    """A raw YouTube-VIS tree under `root`: `JPEGImages/{video}/{frame:05d}.png`
    frames and `ann.json`. Each video holds 1..`max_insts` instances of
    seeded categories in 1..40 moving from frame to frame, each absent from
    about one frame in six (null segmentation); instance k of video v is
    stored as a raw-count RLE, a compressed-string RLE or a polygon by
    (v + k) % 3. The frames' PNG encodes (zlib, which releases the GIL) run
    on a thread pool. Returns (the json's path, the image root)."""
    import json
    from concurrent.futures import ThreadPoolExecutor

    from video_knet_tpu_torch.data.panoptic_png import save_png

    rng = np.random.RandomState(seed)
    h, w = hw
    img_root = os.path.join(root, "JPEGImages")
    videos, annotations = [], []
    writes = []
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for v in range(n_videos):
            name = f"{v:04d}vis"
            os.makedirs(os.path.join(img_root, name), exist_ok=True)
            base = rng.randint(40, 216, 3)
            n_inst = rng.randint(1, max_insts + 1)
            insts = []
            for k in range(n_inst):
                insts.append(dict(
                    kind=(v + k) % 3, cat=int(rng.randint(1, YTVIS_NUM_CATEGORIES + 1)),
                    cy=rng.uniform(0.25, 0.75) * h, cx=rng.uniform(0.2, 0.8) * w,
                    ry=rng.uniform(0.08, 0.25) * h, rx=rng.uniform(0.05, 0.2) * w,
                    vy=rng.uniform(-0.01, 0.01) * h, vx=rng.uniform(-0.02, 0.02) * w,
                    angles=np.sort(rng.uniform(0, 2 * np.pi, rng.randint(5, 9))),
                    radii=rng.uniform(0.6, 1.0, 9), colour=rng.randint(0, 256, 3),
                    absent=rng.rand(n_frames) < 1 / 6, segs=[], boxes=[], areas=[]))
            for f in range(n_frames):
                img = np.empty((h, w, 3), np.int64)
                img[...] = base + (np.arange(h)[:, None, None] * 60 // h)
                for it in insts:
                    mask, seg = (None, None) if it["absent"][f] else _instance_frame(it, f, hw)
                    present = mask is not None and mask.any()
                    if present:
                        img[mask.astype(bool)] = it["colour"]
                    it["segs"].append(seg if present else None)
                    it["boxes"].append(_bbox(mask) if present else None)
                    it["areas"].append(int(mask.sum()) if present else None)
                img = np.clip(img + rng.randint(-10, 11, (h, w, 3)), 0, 255).astype(np.uint8)
                writes.append(pool.submit(save_png, os.path.join(img_root, name, f"{f:05d}.png"),
                                          img))
            videos.append({"id": v + 1, "width": w, "height": h, "length": n_frames,
                           "file_names": [f"{name}/{f:05d}.png" for f in range(n_frames)]})
            for it in insts:
                annotations.append({"id": len(annotations) + 1, "video_id": v + 1,
                                    "category_id": it["cat"], "iscrowd": 0, "width": w,
                                    "height": h, "length": n_frames,
                                    "segmentations": it["segs"], "bboxes": it["boxes"],
                                    "areas": it["areas"]})
        for fut in writes:
            fut.result()
    categories = [{"id": c, "name": f"category{c}", "supercategory": "object"}
                  for c in range(1, YTVIS_NUM_CATEGORIES + 1)]
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"info": {}, "licenses": [], "videos": videos, "annotations": annotations,
                   "categories": categories}, f)
    return ann, img_root


def write_ytvis_cocovid(root: str, **kw) -> tuple[str, str]:
    """`write_ytvis_tree(root, **kw)` converted to COCO-VID by the
    `youtubevis2coco` CLI (`root/cocovid.json`; the CLI prints its line).
    Returns (the converted json's path, the image root)."""
    from video_knet_tpu_torch.tools import youtubevis2coco

    raw, img_root = write_ytvis_tree(root, **kw)
    ann = os.path.join(root, "cocovid.json")
    youtubevis2coco.main([raw, ann])
    return ann, img_root


def write_coco_panoptic_tree(root: str, *, file_names: list[str] | None = None,
                             n_images: int = 4, hw: tuple[int, int] = (480, 640),
                             thing_ids: tuple = (1, 2, 3, 4, 5, 6, 7, 8),
                             stuff_ids: tuple = (92, 93, 95, 100, 107, 109),
                             seed: int = 0) -> tuple[str, str, str]:
    """A COCO panoptic tree under `root`: `images/` PNG images,
    `panoptic/` id2rgb panoptic PNGs and `panoptic.json`. An image holds
    4 horizontal bands of stuff categories, 14 thing boxes (the last one
    crowd), one box of a category the json does not list, and a void
    corner: ~20 segments with seeded ids up to 2^24 - 1. Returns (the
    json's path, the image root, the panoptic root)."""
    n_stuff, n_things = 4, 14
    import json

    from video_knet_tpu_torch.data.coco_panoptic import id2rgb
    from video_knet_tpu_torch.data.panoptic_png import save_png

    rng = np.random.RandomState(seed)
    h, w = hw
    file_names = file_names or [f"{i:012d}.png" for i in range(n_images)]
    img_root, pan_root = os.path.join(root, "images"), os.path.join(root, "panoptic")
    os.makedirs(img_root, exist_ok=True)
    os.makedirs(pan_root, exist_ok=True)
    palette = rng.randint(0, 256, (256, 3))
    images, annotations = [], []
    for i, name in enumerate(file_names):
        n_seg = n_stuff + n_things + 1
        ids: list[int] = []
        while len(ids) < n_seg:
            sid = int(rng.randint(1, 2**24))
            if sid not in ids:
                ids.append(sid)
        seg = np.zeros(hw, np.int64)
        infos = []
        cuts = np.sort(rng.choice(np.arange(1, h), n_stuff - 1, replace=False))
        for k, (y0, y1) in enumerate(zip((0, *cuts), (*cuts, h))):
            seg[y0:y1] = ids[k]
            infos.append({"id": ids[k], "category_id": int(rng.choice(stuff_ids)),
                          "iscrowd": 0})
        for k in range(n_things + 1):
            bh, bw = rng.randint(h // 12, h // 3), rng.randint(w // 12, w // 3)
            y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
            sid = ids[n_stuff + k]
            seg[y:y + bh, x:x + bw] = sid
            cat = int(rng.choice(thing_ids)) if k < n_things else 250  # 250: unknown
            infos.append({"id": sid, "category_id": cat, "iscrowd": int(k == n_things - 1)})
        seg[: h // 16, : w // 16] = 0  # void
        infos = [s for s in infos if (seg == s["id"]).any()]
        img = palette[seg % 256] + rng.randint(-10, 11, (h, w, 3))
        save_png(os.path.join(img_root, name), np.clip(img, 0, 255).astype(np.uint8))
        save_png(os.path.join(pan_root, name), id2rgb(seg))
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w})
        annotations.append({"image_id": i + 1, "file_name": name, "segments_info": infos})
    categories = ([{"id": c, "name": f"thing{c}", "isthing": 1} for c in thing_ids]
                  + [{"id": c, "name": f"stuff{c}", "isthing": 0} for c in stuff_ids])
    ann = os.path.join(root, "panoptic.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return ann, img_root, pan_root


def write_cityscapes_vps_tree(root: str, *, n_clips: int = 2, n_frames: int = 3,
                              hw: tuple[int, int] = (1024, 2048),
                              seed: int = 0) -> tuple[str, str, str]:
    """`write_coco_panoptic_tree` under Cityscapes-VPS's names
    (`{clip:04d}_{frame:05d}_{city}_{seq:06d}_{frameid:06d}_leftImg8bit.png`,
    every fifth frame id) and its 19 classes: trainIds 0-10 stuff, 11-18
    things."""
    names = [f"{c:04d}_{f:05d}_frankfurt_{c:06d}_{5 * f + 4:06d}_leftImg8bit.png"
             for c in range(n_clips) for f in range(n_frames)]
    return write_coco_panoptic_tree(root, file_names=names, hw=hw,
                                    thing_ids=tuple(range(11, 19)),
                                    stuff_ids=tuple(range(11)), seed=seed)
