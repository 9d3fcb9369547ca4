"""Image K-Net panoptic evaluation CLI (per-class PQ/SQ/RQ table).

Counterpart of the reference package's `tools/test_image.py` (the same
arguments and printed lines, plus `--device`): single-image panoptic
inference over a val split, the per-class PQ / SQ / RQ table and one JSON
line of the scalars; the quality gate of the image-pretraining checkpoint
of the two-phase workflow.

Usage:
  python -m video_knet_tpu_torch.tools.test_image --dataset kitti_step \\
      --data-root data/kitti-step --checkpoint ckpt --size 384 1248 [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from video_knet_tpu_torch.tools import _cli


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--dataset", default="kitti_step",
                   choices=["kitti_step", "cityscapes_step", "vipseg"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--size", type=int, nargs=2, default=[384, 1248])
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--max-insts", type=int, default=32)
    return p.parse_args(argv)


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() after each image's
    decode."""
    args = parse_args(argv)
    from video_knet_tpu_torch.config import KNetConfig, vipseg_video_config
    from video_knet_tpu_torch.configs import knet_s3_r50_fpn_cityscapes_step
    from video_knet_tpu_torch.data.datasets import (
        CityscapesSTEPImages,
        KittiStepDVPS,
        VIPSegDVPS,
    )
    from video_knet_tpu_torch.models.knet import KNet, panoptic_decode
    from video_knet_tpu_torch.ops.panoptic import segments_to_host
    from video_knet_tpu_torch.train.eval_hook import evaluate_image_panoptic

    device = _cli.setup_device(args.device)
    if args.dataset == "vipseg":
        ds = VIPSegDVPS(args.data_root, split=args.split)
        v = vipseg_video_config()
        cfg = KNetConfig(num_thing_classes=58, num_stuff_classes=66, rpn=v.rpn, head=v.head,
                         mask_assign_stride=v.mask_assign_stride)
        class_names = None
    else:
        cfg = knet_s3_r50_fpn_cityscapes_step()
        if args.dataset == "kitti_step":
            ds = KittiStepDVPS(args.data_root, split=args.split)
            class_names = ds.CLASSES
        else:
            ds = CityscapesSTEPImages(args.data_root, split=args.split)
            class_names = KittiStepDVPS.CLASSES  # the same 19-class space
    cfg = dataclasses.replace(cfg, backbone=args.backbone, max_insts=args.max_insts)
    model = _cli.build_model(KNet, cfg, device, args.checkpoint)
    h, w = args.size

    @torch.inference_mode()
    def decode_fn(img):
        rpn_out, stage_outs = model(img.to(device))
        res = panoptic_decode(rpn_out, stage_outs, cfg, out_hw=(h, w)).result
        out = segments_to_host(type(res)(*(x.cpu() for x in res)), cfg.num_thing_classes)
        if stats is not None:
            stats.append(time.perf_counter())
        return out

    samples = [ds.frames[k] for k in ds.order] if hasattr(ds, "frames") else ds.samples
    res = evaluate_image_panoptic(
        decode_fn, samples,
        size_hw=(h, w),
        thing_ids_in_seg=ds.thing_ids_in_seg,
        num_classes=cfg.num_classes,
        ann_mode=getattr(ds, "ann_mode", "kitti_rgb"),
        max_images=args.max_images,
        class_names=class_names,
    )
    if "table" in res:
        print(res.pop("table"))
    print(json.dumps({k: round(float(v), 2) for k, v in res.items() if not hasattr(v, "shape")}))


if __name__ == "__main__":
    main()
