"""Offline windowed VPQ over dumped prediction PNGs vs DVPS GT.

Counterpart of the reference package's `tools/eval_dvpq.py` (the same
arguments and printed lines; numpy only): for each sequence, read
`{result}/panoptic/{seq}/*_cat.png` + `*_ins.png` and the GT panoptic PNGs,
compute windowed VPQ for each k in --eval-frames (frames concatenated along
x), print PQ / thing-PQ / stuff-PQ. Sequences are scored in order.

Usage:
  python -m video_knet_tpu_torch.tools.eval_dvpq RESULT_DIR \\
      --gt-dir data/kitti-step/video_sequence/val [--eval-frames 1 2 3 4]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("result_path")
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--eval-frames", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--thing-ids", type=int, nargs="+", default=[11, 13])
    p.add_argument("--ann-mode", default="kitti_rgb",
                   choices=["kitti_rgb", "vipseg", "divisor", "class_instance"],
                   help="GT panoptic encoding (dataset-dependent)")
    return p.parse_args(argv)


def _gt_files(gt_dir: str, seq: str) -> list[str]:
    """GT panoptic files of one sequence: the flat video_sequence layout
    ({seq:06d}_*panoptic*) or per-video subdirectories (VIP-Seg panomasks)."""
    subdirs = sorted(d for d in os.listdir(gt_dir) if os.path.isdir(os.path.join(gt_dir, d)))
    if subdirs:
        vdir = os.path.join(gt_dir, subdirs[int(seq)])
        return [os.path.join(vdir, f) for f in sorted(os.listdir(vdir)) if f.endswith(".png")]
    return [os.path.join(gt_dir, f) for f in sorted(os.listdir(gt_dir))
            if f.startswith(f"{int(seq):06d}") and "panoptic" in f]


def _load_seq(pred_dir: str, gt_dir: str, seq: str, ann_mode: str = "kitti_rgb"):
    from video_knet_tpu_torch.data.panoptic_png import decode_panoptic_ann, load_png
    from video_knet_tpu_torch.eval.vpq import MAX_INS

    d = os.path.join(pred_dir, seq)
    cats = sorted(f for f in os.listdir(d) if f.endswith("_cat.png"))
    inss = sorted(f for f in os.listdir(d) if f.endswith("_ins.png"))
    pred_cats = [load_png(os.path.join(d, f)).astype(np.int64) for f in cats]
    pred_inss = [load_png(os.path.join(d, f)).astype(np.int64) for f in inss]
    gt_pans = []
    for f in _gt_files(gt_dir, seq):
        sem, inst = decode_panoptic_ann(f, ann_mode)
        gt_pans.append(sem.astype(np.int64) * MAX_INS + inst.astype(np.int64))
    return pred_cats, pred_inss, gt_pans


def main(argv=None):
    args = parse_args(argv)
    from video_knet_tpu_torch.eval.vpq import VPQStats, vpq_from_stats, window_vpq

    pred_dir = os.path.join(args.result_path, "panoptic")
    seqs = sorted(os.listdir(pred_dir), key=lambda s: int(s))
    things = np.zeros(args.num_classes, bool)
    for t in args.thing_ids:
        things[t] = True

    for k in args.eval_frames:
        total = VPQStats(num_cat=args.num_classes + 1)
        for seq in seqs:
            pc, pi, gp = _load_seq(pred_dir, args.gt_dir, seq, args.ann_mode)
            n = min(len(pc), len(gp))
            total += window_vpq(pc[:n], pi[:n], gp[:n], eval_frames=k,
                                num_cat=args.num_classes + 1)
        res = vpq_from_stats(total, num_classes=args.num_classes, things_index=things)
        print(f"k={k}: PQ {res['PQ']:.1f}  PQ_th {res['PQ_th']:.1f}  PQ_st {res['PQ_st']:.1f}")


if __name__ == "__main__":
    main()
