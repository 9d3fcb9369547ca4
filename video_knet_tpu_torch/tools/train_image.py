"""Train image K-Net (Cityscapes-STEP / COCO panoptic pretraining) on one GPU.

Counterpart of the reference package's `tools/train_image.py` (the same
arguments and printed lines, plus `--device`): phase 1 of the two-phase
workflow (pretrain the image model, then `--load-from` it into
`train_vps`). Samples are read, augmented and packed on the host in a
seeded order, stacked into batches of `--batch-size`, and each batch takes
one train step (`train/image.py`); a JSON record every `--log-interval`
steps, a checkpoint a epoch in `work_dir/ckpt/step_{epoch}`, and with
`--eval-interval` the per-class PQ table on the val split (not for coco).

Usage:
  python -m video_knet_tpu_torch.tools.train_image --dataset cityscapes_step \\
      --data-root data/cityscapes --epochs 8 --batch-size 8 [--device cpu]
  python -m video_knet_tpu_torch.tools.train_image --dataset coco \\
      --ann-file panoptic_train.json --img-root train2017 --pan-root panoptic_train2017
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
    p.add_argument("--dataset", default="cityscapes_step",
                   choices=["cityscapes_step", "coco", "kitti_step"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--ann-file", default=None)
    p.add_argument("--img-root", default=None)
    p.add_argument("--pan-root", default=None)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--crop", type=int, nargs=2, default=[512, 1024])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--work-dir", default="work_dirs/image_knet")
    p.add_argument("--load-from", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-insts", type=int, default=32)
    p.add_argument("--eval-interval", type=int, default=0,
                   help="evaluate PQ on the val split every N epochs (0 = off)")
    p.add_argument("--eval-size", type=int, nargs=2, default=None)
    p.add_argument("--eval-max-images", type=int, default=None)
    return p.parse_args(argv)


def _run_eval(args, cfg, model, device) -> dict:
    """Per-class PQ / SQ / RQ on the val split (the reference's EvalHook,
    kitti_step_dvps.py:190-318): prints the table, returns the scalars."""
    from video_knet_tpu_torch.data.datasets import CityscapesSTEPImages, KittiStepDVPS
    from video_knet_tpu_torch.models.knet import panoptic_decode
    from video_knet_tpu_torch.ops.panoptic import segments_to_host
    from video_knet_tpu_torch.train.eval_hook import evaluate_image_panoptic

    if args.dataset == "kitti_step":
        ds = KittiStepDVPS(args.data_root, split="val")
        samples = [ds.frames[k] for k in ds.order]
    else:
        ds = CityscapesSTEPImages(args.data_root, split="val")
        samples = ds.samples
    h, w = args.eval_size or args.crop

    @torch.inference_mode()
    def decode_fn(img):
        rpn_out, stage_outs = model(img.to(device))
        res = panoptic_decode(rpn_out, stage_outs, cfg, out_hw=(h, w)).result
        return segments_to_host(type(res)(*(x.cpu() for x in res)), cfg.num_thing_classes)

    res = evaluate_image_panoptic(
        decode_fn, samples,
        size_hw=(h, w),
        thing_ids_in_seg=ds.thing_ids_in_seg,
        num_classes=cfg.num_classes,
        ann_mode=getattr(ds, "ann_mode", "kitti_rgb"),
        max_images=args.eval_max_images,
        class_names=KittiStepDVPS.CLASSES,
    )
    print(res.pop("table", ""))
    return {k: float(v) for k, v in res.items() if not hasattr(v, "shape")}


def _iter_samples(args, cfg, rng: np.random.RandomState):
    """Yields (img [H, W, 3] float32, PanopticGT of numpy arrays) at crop
    size, in `rng`'s order, with `rng`'s augmentations."""
    from video_knet_tpu_torch.data.panoptic_png import decode_kitti_panoptic, load_png
    from video_knet_tpu_torch.data.transforms import (
        apply_image_transform,
        apply_mask_transform,
        pack_panoptic_gt,
        sample_transform_params,
    )

    crop = tuple(args.crop)
    if args.dataset == "coco":
        from video_knet_tpu_torch.data.coco_panoptic import CocoPanopticDataset

        ds = CocoPanopticDataset(args.ann_file, args.img_root, args.pan_root)
        for i in rng.permutation(len(ds)):
            s = ds.samples[int(i)]
            sem, inst = ds.load_sem_inst(int(i))
            p = sample_transform_params(rng)
            img = apply_image_transform(load_png(s.img), p, crop)  # a JPEG through PIL
            sem_t = apply_mask_transform(sem, p, crop)
            inst_t = apply_mask_transform(inst, p, crop, pad_value=0)
            yield img, pack_panoptic_gt(
                sem_t, inst_t,
                thing_ids_in_seg=ds.thing_ids_in_seg,
                num_stuff_classes=ds.num_stuff_classes,
                max_insts=cfg.max_insts,
                assign_stride=cfg.mask_assign_stride,
            )
    else:
        from video_knet_tpu_torch.data.datasets import CityscapesSTEPImages, KittiStepDVPS

        if args.dataset == "kitti_step":
            scan = KittiStepDVPS(args.data_root, split="train")
            samples = [scan.frames[k] for k in scan.order]
        else:
            scan = CityscapesSTEPImages(args.data_root, split="train")
            samples = scan.samples
        for i in rng.permutation(len(samples)):
            s = samples[int(i)]
            if s.ann is None:
                continue
            sem, inst = decode_kitti_panoptic(load_png(s.ann))
            p = sample_transform_params(rng)
            img = apply_image_transform(load_png(s.img), p, crop)
            sem_t = apply_mask_transform(sem, p, crop)
            inst_t = apply_mask_transform(inst, p, crop, pad_value=0)
            yield img, pack_panoptic_gt(
                sem_t, inst_t,
                thing_ids_in_seg=scan.thing_ids_in_seg,
                num_stuff_classes=17,
                max_insts=cfg.max_insts,
                assign_stride=cfg.mask_assign_stride,
            )


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() after each step
    (after its log record, if it has one)."""
    args = parse_args(argv)
    from video_knet_tpu_torch.configs import (
        knet_s3_r50_fpn_cityscapes_step,
        knet_s3_r50_fpn_coco_panoptic,
    )
    from video_knet_tpu_torch.models.knet import KNet
    from video_knet_tpu_torch.ops.targets import PanopticGT
    from video_knet_tpu_torch.tools.train_vps import host_losses, load_weights
    from video_knet_tpu_torch.train.image import ImageBatch, train_step
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.utils.checkpoint import save_checkpoint

    device = _cli.setup_device(args.device)
    cfg = (knet_s3_r50_fpn_coco_panoptic() if args.dataset == "coco"
           else knet_s3_r50_fpn_cityscapes_step())
    cfg = dataclasses.replace(cfg, backbone=args.backbone, max_insts=args.max_insts)

    model = KNet(cfg, generator=torch.Generator().manual_seed(args.seed), device=device)
    if args.load_from:
        load_weights(model, args.load_from)
    # the reference package's fixed 1000 steps an epoch: the schedule's decay
    # epochs count in thousands of steps, whatever the dataset's length
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000,
                                                     base_lr=args.lr))

    def to_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device, non_blocking=True)

    os.makedirs(args.work_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    b = args.batch_size
    for epoch in range(args.epochs):
        t0 = time.time()
        imgs, gts = [], []
        it = 0
        for img, gt in _iter_samples(args, cfg, rng):
            imgs.append(img)
            gts.append(gt)
            if len(imgs) < b:
                continue
            batch = ImageBatch(to_device(np.stack(imgs)),
                               PanopticGT(*[to_device(np.stack(x)) for x in zip(*gts)]))
            state, losses = train_step(state, batch)
            imgs, gts = [], []
            it += 1
            if it % args.log_interval == 0:
                print(json.dumps({"epoch": epoch, "iter": it, **{
                    k: round(v, 4) for k, v in host_losses(losses).items()}}))
            if stats is not None:
                stats.append(time.perf_counter())
        save_checkpoint(os.path.join(args.work_dir, "ckpt"), state, step=epoch + 1)
        print(f"epoch {epoch + 1} done in {time.time() - t0:.1f}s")
        if (args.eval_interval and args.dataset != "coco"
                and (epoch + 1) % args.eval_interval == 0):
            metrics = _run_eval(args, cfg, model, device)
            print(json.dumps({"epoch": epoch + 1, "eval": {
                k: round(v, 2) for k, v in metrics.items()}}))


if __name__ == "__main__":
    main()
