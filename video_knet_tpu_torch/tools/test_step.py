"""Online VPS inference over a DVPS dataset; dumps per-frame PNGs.

Counterpart of the reference package's `tools/test_step.py` (the same
arguments, files and printed lines, plus `--device`): for every frame in
sequence order run the stateful per-frame step (the tracker resets at
sequence boundaries) and write `{seq}/{frame}_cat.png`, `{seq}/{frame}_ins.png`
and the 3-channel `final/` visualization read by the offline VPQ / STQ
evaluators. With `--tta-scales` the semantic map is the multi-scale (and
`--tta-flip`) fusion of `data/tta.py`; the panoptic and track outputs stay
single-scale.

Usage:
  python -m video_knet_tpu_torch.tools.test_step --data-root data/kitti-step \\
      --checkpoint ckpt --out out/vps [--split val] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from video_knet_tpu_torch.tools import _cli


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True)
    p.add_argument("--dataset", default="kitti_step", choices=["kitti_step", "vipseg"])
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--split", default="val")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, nargs=2, default=[384, 1248],
                   help="inference H W (static shape)")
    p.add_argument("--tracker", default="quasi_dense",
                   choices=["quasi_dense", "quasi_dense_host", "unitrack",
                            "tao", "simple", "overlap"])
    p.add_argument("--appearance", default=None,
                   choices=[None, "resnet18", "resnet34", "resnet50", "random"],
                   help="UniTrack frozen appearance encoder (--tracker unitrack): "
                        "embeddings come from this net over the raw frame instead of "
                        "the track head")
    p.add_argument("--appearance-checkpoint", default=None,
                   help="torchvision-style .pth for the appearance encoder")
    p.add_argument("--tta-scales", type=float, nargs="*", default=None,
                   help="multi-scale TTA ratios, e.g. 0.75 1.0 1.25 "
                        "(MultiScaleFlipAugVideo parity)")
    p.add_argument("--tta-flip", action="store_true", help="add horizontal-flip TTA")
    return p.parse_args(argv)


def load_appearance(name: str, checkpoint: str | None, device: torch.device):
    """The UniTrack appearance encoder `name`, seeded, or with a torchvision
    checkpoint's weights (its layers the encoder removed are left out; every
    key the encoder has must be in it)."""
    from video_knet_tpu_torch.models.video.appearance import make_appearance_model
    from video_knet_tpu_torch.utils.checkpoint import import_torch_resnet, load_torch_file

    model = make_appearance_model(name, device=device)
    if checkpoint:
        imported = import_torch_resnet(load_torch_file(checkpoint), prefix="")
        own = model.state_dict()
        missing = sorted(set(own) - set(imported))
        if missing:
            raise KeyError(f"{checkpoint}: no weights for {missing[:8]}")
        model.load_state_dict({k: imported[k] for k in own}, strict=True)
    return model


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() as each frame's
    files are written."""
    args = parse_args(argv)
    from video_knet_tpu_torch.config import kitti_step_video_config, vipseg_video_config
    from video_knet_tpu_torch.data.datasets import KittiStepDVPS, VIPSegDVPS
    from video_knet_tpu_torch.data.panoptic_png import (
        encode_two_channel_vps,
        load_png,
        save_png,
    )
    from video_knet_tpu_torch.data.transforms import keep_ratio_resize_pad, nearest_resize
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

    device = _cli.setup_device(args.device)
    cfg = kitti_step_video_config() if args.dataset == "kitti_step" else vipseg_video_config()
    cfg = dataclasses.replace(cfg, backbone=args.backbone)
    ds_cls = KittiStepDVPS if args.dataset == "kitti_step" else VIPSegDVPS
    ds = ds_cls(args.data_root, split=args.split)
    model = _cli.build_model(VideoKNet, cfg, device, args.checkpoint)
    h, w = args.size

    appearance_fn = None
    if args.appearance:
        from video_knet_tpu_torch.models.video.appearance import make_appearance_fn

        appearance_fn = make_appearance_fn(
            load_appearance(args.appearance, args.appearance_checkpoint, device))

    thing_ids = ds.thing_ids_in_seg if args.dataset == "kitti_step" else None
    pipe = VPSInferencePipeline(model, cfg, (h, w), thing_ids_in_orig=thing_ids,
                                tracker_type=args.tracker, device=device,
                                appearance_fn=appearance_fn)

    tta_fn = tta_lut = None
    if args.tta_scales:
        # fuse the semantic logits across scales / flips (data/tta.py)
        from video_knet_tpu_torch.data.tta import (
            make_tta_semantic_fn,
            things_first_to_dataset_lut,
        )

        tta_fn = make_tta_semantic_fn(model, cfg, (h, w), args.tta_scales,
                                      flip=args.tta_flip, device=device)
        tta_lut = things_first_to_dataset_lut(cfg.num_thing_classes, cfg.num_stuff_classes,
                                              thing_ids)

    os.makedirs(args.out, exist_ok=True)
    n = 0
    t0 = time.time()
    pairs = list(ds.iter_test())
    flags = [f for _, f in pairs]
    meta: list = []

    def frames():
        for sample, _ in pairs:
            rgb = load_png(sample.img)
            # keep-ratio resize into the static canvas (the reference's test
            # pipeline: keep_ratio Resize + Pad); cropped back to content below
            x, content = keep_ratio_resize_pad(rgb, (h, w))
            meta.append((rgb.shape[:2], content, rgb if tta_fn else None))
            yield torch.from_numpy(x)[None]

    # windowed pipelined inference: the device steps of the next frames
    # overlap the tracking / PNG writing of the previous ones. The generator
    # runs ahead of the results, and meta[i] is frame i's whatever the
    # look-ahead: results come in frame order.
    for i, res in enumerate(pipe.run_sequence(frames(), flags)):
        sample = pairs[i][0]
        ori_hw, (ch, cw), rgb = meta[i]
        seq_dir = os.path.join(args.out, "panoptic", str(sample.seq_id))
        final_dir = os.path.join(args.out, "final", str(sample.seq_id))
        os.makedirs(seq_dir, exist_ok=True)
        os.makedirs(final_dir, exist_ok=True)
        # label maps back to the original resolution (nearest)
        sem = nearest_resize(res.semantic_map.astype(np.int32)[:ch, :cw], ori_hw)
        if tta_fn is not None:
            # the fused multi-scale semantic map replaces the single-scale one
            sem = nearest_resize(tta_lut[tta_fn(rgb)][:ch, :cw], ori_hw)
        trk = nearest_resize(res.track_map.astype(np.int32)[:ch, :cw], ori_hw)
        stem = f"{sample.img_id:06d}"
        save_png(os.path.join(seq_dir, stem + "_cat.png"), sem.astype(np.uint8))
        save_png(os.path.join(seq_dir, stem + "_ins.png"), (trk % 65536).astype(np.uint16))
        save_png(os.path.join(final_dir, stem + ".png"), encode_two_channel_vps(sem, trk))
        n += 1
        if stats is not None:
            stats.append(time.perf_counter())
        if n % 50 == 0:
            print(f"{n} frames, {n / (time.time() - t0):.2f} fps")
    print(f"done: {n} frames in {time.time() - t0:.1f}s -> {args.out}")


if __name__ == "__main__":
    main()
