"""Convert raw YouTube-VIS annotations to the COCO-VID json the reader takes.

Counterpart of the reference package's `tools/youtubevis2coco.py` (the same
arguments, JSON and printed line): the official YT-VIS json stores
per-video annotation tracks (`segmentations` / `bboxes` / `areas` lists
indexed by frame); this flattens them to per-image `images` /
`annotations` entries with `video_id`, `frame_id` and a video-level
`instance_id` (frames whose segmentation is null get no entry).

Usage:
  python -m video_knet_tpu_torch.tools.youtubevis2coco train.json train_cocovid.json
"""

from __future__ import annotations

import argparse
import json


def convert(src: dict) -> dict:
    images, annotations = [], []
    img_id, ann_id = 1, 1
    frame_index: dict[tuple[int, int], int] = {}
    for video in src["videos"]:
        for f, fname in enumerate(video["file_names"]):
            images.append(
                {
                    "id": img_id,
                    "video_id": video["id"],
                    "frame_id": f,
                    "file_name": fname,
                    "height": video["height"],
                    "width": video["width"],
                }
            )
            frame_index[(video["id"], f)] = img_id
            img_id += 1

    for inst_id, ann in enumerate(src.get("annotations", []), start=1):
        vid = ann["video_id"]
        for f, seg in enumerate(ann["segmentations"]):
            if seg is None:
                continue
            bbox = ann["bboxes"][f] if ann.get("bboxes") else None
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": frame_index[(vid, f)],
                    "video_id": vid,
                    "instance_id": inst_id,
                    "category_id": ann["category_id"],
                    "segmentation": seg,
                    "bbox": bbox,
                    "area": ann["areas"][f] if ann.get("areas") else None,
                    "iscrowd": ann.get("iscrowd", 0),
                }
            )
            ann_id += 1

    return {
        "images": images,
        "annotations": annotations,
        "categories": src.get("categories", []),
        "videos": [{"id": v["id"]} for v in src["videos"]],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    with open(args.src) as f:
        src = json.load(f)
    out = convert(src)
    with open(args.dst, "w") as f:
        json.dump(out, f)
    print(
        f"wrote {args.dst}: {len(out['images'])} images, "
        f"{len(out['annotations'])} annotations, {len(out['videos'])} videos"
    )


if __name__ == "__main__":
    main()
