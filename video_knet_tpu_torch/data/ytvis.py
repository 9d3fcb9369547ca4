"""YouTube-VIS dataset (COCO-VID json) and the submission writer.

Counterpart of `video_knet_tpu/data/ytvis.py` (mmtrack's CocoVID parsing
as the reference uses it: coco_video_parser.py, coco_video_dataset.py,
youtube_vis_dataset.py): videos as ordered frame lists with per-frame
annotations keyed by a video-level instance id, clip sampling for training
(a key frame and refs within `frame_range`), fixed-slot GT tubes, and the
YT-VIS submission (`results.json` of per-track RLE segmentations, zipped).
Numpy and the standard library only; the same draws and arrays as JAX's.
"""

from __future__ import annotations

import json
import os
import zipfile
from dataclasses import dataclass

import numpy as np

from video_knet_tpu_torch.data.polygon import polygons_to_mask
from video_knet_tpu_torch.data.rle import decode_mask, encode_mask


@dataclass
class VideoRecord:
    video_id: int
    frames: list[dict]  # COCO image dicts in frame order
    anns_by_frame: list[list[dict]]  # per frame


class YouTubeVISDataset:
    """Reader of the COCO-VID json that `tools/youtubevis2coco.py` writes."""

    def __init__(self, ann_file: str, img_root: str | None = None):
        with open(ann_file) as f:
            data = json.load(f)
        self.categories = {c["id"]: c["name"] for c in data.get("categories", [])}
        self.cat_ids = sorted(self.categories)
        self.img_root = img_root

        vids: dict[int, list[dict]] = {}
        for img in data["images"]:
            vids.setdefault(img["video_id"], []).append(img)
        for v in vids.values():
            v.sort(key=lambda im: im.get("frame_id", im["id"]))

        anns_by_img: dict[int, list[dict]] = {}
        for ann in data.get("annotations", []):
            anns_by_img.setdefault(ann["image_id"], []).append(ann)

        self.videos = [
            VideoRecord(
                video_id=vid,
                frames=frames,
                anns_by_frame=[anns_by_img.get(im["id"], []) for im in frames],
            )
            for vid, frames in sorted(vids.items())
        ]

    def __len__(self) -> int:
        return len(self.videos)

    def frame_path(self, frame: dict) -> str:
        """The file of a frame's image dict, under `img_root` if one is set."""
        path = frame["file_name"]
        return os.path.join(self.img_root, path) if self.img_root else path

    def sample_clip(
        self,
        video_idx: int,
        rng: np.random.RandomState,
        *,
        num_frames: int = 5,
        frame_range: tuple[int, int] = (-2, 2),
        method: str = "uniform",
        filter_key_img: bool = True,
    ) -> list[int]:
        """Clip frame indices: a key frame, then its refs within
        `frame_range`, sorted (the reference's ref_img_sampling).

        `uniform` draws refs without replacement from the window (the key
        excluded when `filter_key_img`); `bilateral_uniform` draws
        min(num_refs // 2, side size) from each side of the key, left first,
        and fills the short side's deficit from the long side. The reference
        returns a SHORT ref list near clip boundaries; a clip here has one
        length, so a remaining deficit is filled with the in-window non-key
        frames nearest the key (repeated), and the key itself repeats only in
        a single-frame video."""
        v = self.videos[video_idx]
        n = len(v.frames)
        key = int(rng.randint(0, n))
        num_refs = num_frames - 1
        lo = max(0, key + frame_range[0])
        hi = min(n - 1, key + frame_range[1])
        window = [i for i in range(lo, hi + 1)
                  if not (filter_key_img and i == key)]
        refs: list[int] = []
        if method == "bilateral_uniform":
            left = [i for i in window if i <= key]
            right = [i for i in window if i > key]
            half = num_refs // 2
            take_left = min(half, len(left))
            take_right = min(num_refs - take_left, len(right))
            take_left = min(num_refs - take_right, len(left))
            refs += [int(i) for i in rng.choice(left, take_left, replace=False)]
            refs += [int(i) for i in rng.choice(right, take_right, replace=False)]
        else:
            take = min(num_refs, len(window))
            refs = [int(i) for i in rng.choice(window, take, replace=False)]
        if len(refs) < num_refs and window:
            near = sorted(window, key=lambda i: abs(i - key))
            k = 0
            while len(refs) < num_refs:
                refs.append(int(near[k % len(near)]))
                k += 1
        refs += [key] * (num_refs - len(refs))  # a single-frame video only
        return [key] + sorted(refs)

    def clip_gt_arrays(
        self, video_idx: int, frame_idxs: list[int], *, max_insts: int,
        hw: tuple[int, int] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fixed-slot GT tubes: masks [G, T, H, W] float32, labels [G] int32
        (index into `cat_ids`), valid [G] bool. Slots in first-seen order;
        instances past `max_insts` are dropped; a `None` segmentation leaves
        the frame empty; RLE dicts are decoded, polygon lists rasterized."""
        v = self.videos[video_idx]
        t = len(frame_idxs)
        if hw is None:
            im0 = v.frames[0]
            hw = (im0["height"], im0["width"])
        inst_slots: dict[int, int] = {}
        masks = np.zeros((max_insts, t, *hw), np.float32)
        labels = np.zeros((max_insts,), np.int32)
        valid = np.zeros((max_insts,), bool)
        for ti, fi in enumerate(frame_idxs):
            for ann in v.anns_by_frame[fi]:
                iid = ann.get("instance_id", ann["id"])
                if iid not in inst_slots:
                    if len(inst_slots) >= max_insts:
                        continue
                    inst_slots[iid] = len(inst_slots)
                    labels[inst_slots[iid]] = self.cat_ids.index(ann["category_id"])
                    valid[inst_slots[iid]] = True
                seg = ann.get("segmentation")
                if seg is None:
                    continue
                if isinstance(seg, dict):
                    m = decode_mask(seg).astype(np.float32)
                else:  # a COCO polygon list
                    m = polygons_to_mask(seg, *hw).astype(np.float32)
                masks[inst_slots[iid], ti] = m[: hw[0], : hw[1]]
        return masks, labels, valid


def format_vis_results(
    per_video_tracks: list[list[dict]],
    out_dir: str,
    *,
    make_zip: bool = True,
) -> str:
    """Write the YT-VIS submission (the reference's youtube_vis_dataset.py
    format_results): `results.json` and, with `make_zip`,
    `submission_file.zip` holding it. Returns the json's path.

    per_video_tracks: for each video, track dicts {video_id, segmentations
    (an RLE or None a frame), and category_id or category_votes {cat:
    summed score} (the argmax wins), and score or frame_scores {frame:
    score} (their mean)}."""
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for tracks in per_video_tracks:
        for tr in tracks:
            if "category_votes" in tr:
                cat = max(tr["category_votes"].items(), key=lambda kv: kv[1])[0]
            else:
                cat = tr["category_id"]
            if "frame_scores" in tr:
                score = float(np.mean(list(tr["frame_scores"].values())))
            else:
                score = float(tr["score"])
            results.append(
                {
                    "video_id": tr["video_id"],
                    "category_id": int(cat),
                    "score": score,
                    "segmentations": tr["segmentations"],
                }
            )
    json_path = os.path.join(out_dir, "results.json")
    with open(json_path, "w") as f:
        json.dump(results, f)
    if make_zip:
        zip_path = os.path.join(out_dir, "submission_file.zip")
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
            z.write(json_path, arcname="results.json")
    return json_path


def tracks_from_prediction(
    video_id: int,
    masks: np.ndarray,  # [T, K, H, W] logits or probabilities
    labels: np.ndarray,  # [K]
    scores: np.ndarray,  # [K]
    cat_ids: list[int],
    *,
    mask_thr: float = 0.5,
    score_thr: float = 0.0,
) -> list[dict]:
    """One video's decode -> submission track dicts (an RLE a frame, None
    where the mask is empty). The threshold follows the data: logits (any
    value below 0) at 0, probabilities at `mask_thr`."""
    t, k = masks.shape[:2]
    binary = masks > (0.0 if masks.min() < 0 else mask_thr)
    tracks = []
    for j in range(k):
        if scores[j] < score_thr:
            continue
        segs = []
        for ti in range(t):
            m = binary[ti, j]
            segs.append(encode_mask(m) if m.any() else None)
        tracks.append(
            {
                "video_id": video_id,
                "track_id": j,
                "category_id": cat_ids[int(labels[j])],
                "score": float(scores[j]),
                "segmentations": segs,
            }
        )
    return tracks
