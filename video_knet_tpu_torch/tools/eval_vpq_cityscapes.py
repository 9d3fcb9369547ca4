"""Cityscapes-VPS VPQ: windowed PQ with lambda in {0, 5, 10, 15} frames.

Counterpart of the reference package's `tools/eval_vpq_cityscapes.py` (the
same arguments and printed lines; numpy only; the reference's
tools/eval_vps.py + cityscapesvps_eval.py): every val clip contributes its
evaluated frames; VPQ^lambda concatenates (lambda/5 + 1) consecutive
evaluated frames a window. Inputs are the cat / ins PNG dumps of `test_step`
against 2-channel (category, instance) GT panoptic PNGs.

Usage:
  python -m video_knet_tpu_torch.tools.eval_vpq_cityscapes RESULT_DIR \\
      --gt-dir gtFinePanoptic/val
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("result_path")
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--thing-ids", type=int, nargs="+", default=list(range(11, 19)))
    p.add_argument("--lambdas", type=int, nargs="+", default=[0, 5, 10, 15])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.eval.vpq import MAX_INS, VPQStats, vpq_from_stats, window_vpq

    pred_dir = os.path.join(args.result_path, "panoptic")
    things = np.zeros(args.num_classes, bool)
    for t in args.thing_ids:
        things[t] = True

    seqs = sorted(os.listdir(pred_dir))
    for lam in args.lambdas:
        k = lam // 5 + 1
        total = VPQStats(num_cat=args.num_classes + 1)
        for seq in seqs:
            d = os.path.join(pred_dir, seq)
            cats = sorted(f for f in os.listdir(d) if f.endswith("_cat.png"))
            inss = sorted(f for f in os.listdir(d) if f.endswith("_ins.png"))
            gts = sorted(f for f in os.listdir(args.gt_dir) if f.startswith(seq))
            pc = [load_png(os.path.join(d, f)).astype(np.int64) for f in cats]
            pi = [load_png(os.path.join(d, f)).astype(np.int64) for f in inss]
            gp = []
            for f in gts:
                g = load_png(os.path.join(args.gt_dir, f)).astype(np.int64)
                # a 2-channel (cat, ins) map stored as RGB
                gp.append(g[..., 0] * MAX_INS + g[..., 1] if g.ndim == 3 else g)
            n = min(len(pc), len(gp))
            if n >= k:
                total += window_vpq(pc[:n], pi[:n], gp[:n], eval_frames=k,
                                    num_cat=args.num_classes + 1)
        res = vpq_from_stats(total, num_classes=args.num_classes, things_index=things)
        print(f"lambda={lam}: VPQ {res['PQ']:.1f}  th {res['PQ_th']:.1f}  "
              f"st {res['PQ_st']:.1f}")


if __name__ == "__main__":
    main()
