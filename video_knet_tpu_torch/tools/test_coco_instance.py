"""COCO instance-segmentation inference CLI (results-json dump).

Counterpart of the reference package's `tools/test_coco_instance.py` (the
same arguments, file and printed line, plus `--device`): image K-Net in
instance mode over a COCO-format image list, writing the COCO `segm`
results json (RLE masks, scores, category ids) for offline COCOeval.

Usage:
  python -m video_knet_tpu_torch.tools.test_coco_instance --ann-file ann.json \\
      --img-root imgs --checkpoint ckpt --size 800 1344 --out work_dirs/coco [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from video_knet_tpu_torch.tools import _cli


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--ann-file", required=True)
    p.add_argument("--img-root", default=None)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--size", type=int, nargs=2, default=[800, 1344])
    p.add_argument("--score-thr", type=float, default=0.0)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def coco_config(backbone: str, n_cats: int):
    """The COCO instance preset with `backbone` and, when the annotation file
    lists categories, their count as the class count."""
    from video_knet_tpu_torch.configs import get_config

    cfg = get_config("knet_s3_r50_fpn_ms-3x_coco")
    return dataclasses.replace(
        cfg, backbone=backbone,
        num_thing_classes=n_cats or cfg.num_thing_classes,
        rpn=dataclasses.replace(cfg.rpn, num_classes=n_cats or cfg.rpn.num_classes,
                                num_thing_classes=n_cats or cfg.rpn.num_thing_classes),
        head=dataclasses.replace(cfg.head, num_classes=n_cats or cfg.head.num_classes,
                                 num_thing_classes=n_cats or cfg.head.num_thing_classes),
    )


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() after each image."""
    args = parse_args(argv)
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.data.transforms import keep_ratio_resize_pad, nearest_resize
    from video_knet_tpu_torch.eval.coco_instance import (
        instances_to_coco_json,
        write_coco_results,
    )
    from video_knet_tpu_torch.models.knet import KNet, instance_decode

    device = _cli.setup_device(args.device)
    with open(args.ann_file) as f:
        coco = json.load(f)
    cat_ids = sorted(c["id"] for c in coco.get("categories", []))
    images = coco["images"]
    if args.max_images:
        images = images[: args.max_images]
    cfg = coco_config(args.backbone, len(cat_ids))
    model = _cli.build_model(KNet, cfg, device, args.checkpoint)
    h, w = args.size

    results = []
    for im in images:
        path = im["file_name"]
        if args.img_root:
            path = os.path.join(args.img_root, path)
        rgb = load_png(path)
        x, (ch, cw) = keep_ratio_resize_pad(rgb, (h, w))
        with torch.inference_mode():
            rpn_out, stage_outs = model(torch.from_numpy(x)[None].to(device))
            pred = instance_decode(rpn_out, stage_outs, cfg, out_hw=(h, w))
        masks = pred.masks.cpu().numpy()[:, :ch, :cw]
        ori = (im.get("height", rgb.shape[0]), im.get("width", rgb.shape[1]))
        masks = np.stack([nearest_resize(m, ori) for m in masks])
        results.extend(instances_to_coco_json(
            im["id"], masks, pred.labels.cpu().numpy(), pred.scores.cpu().numpy(),
            cat_ids or list(range(cfg.num_thing_classes)),
            mask_thr=cfg.test.mask_thr, score_thr=args.score_thr,
        ))
        if stats is not None:
            stats.append(time.perf_counter())
    path = write_coco_results(results, args.out)
    print(json.dumps({"results": path, "n_detections": len(results),
                      "n_images": len(images)}))


if __name__ == "__main__":
    main()
