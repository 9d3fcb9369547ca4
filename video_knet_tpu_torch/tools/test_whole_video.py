"""Whole-video VIS inference and the YT-VIS submission.

Counterpart of the reference package's `tools/test_whole_video.py` (the
same arguments and printed lines, plus `--device`): each video's frames are
read, resized to `--size` and normalized on the host, then run through
`KNetVIS` and `vis_decode` on the device in clips of `--clip-len` frames
(the last clip padded by repeating its final frame); each frame's masks
become RLEs (`tracks_from_prediction`) in `results.json` and
`submission_file.zip` (`format_vis_results`).

Usage:
  python -m video_knet_tpu_torch.tools.test_whole_video --ann-file valid.json \\
      --img-root valid/JPEGImages --checkpoint ckpt --out out/vis \\
      [--clip-len 8] [--size 360 640] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from video_knet_tpu_torch.data.panoptic_png import load_png
from video_knet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, bilinear_resize
from video_knet_tpu_torch.tools import _cli


def video_frames(ds, video, hw: tuple[int, int]) -> list[np.ndarray]:
    """A video's frames as the model takes them: read, bilinear-resized to
    `hw` and ImageNet-normalized on the host, float32 [h, w, 3] each."""
    return [(bilinear_resize(load_png(ds.frame_path(im)), hw) - IMAGENET_MEAN) / IMAGENET_STD
            for im in video.frames]


def video_prediction(run_clip, frames: list[np.ndarray], clip_len: int):
    """(masks [n, K, h, w], labels [K], scores [K]) of a video's `frames`:
    `run_clip(clip)` takes [1, clip_len, h, w, 3] and gives (masks [clip_len,
    K, h, w], labels, scores) as numpy; the last clip repeats its final
    frame, and only the real frames' masks are kept."""
    n = len(frames)
    per_frame_masks = []
    labels = scores = None
    for start in range(0, n, clip_len):
        chunk = frames[start : start + clip_len]
        while len(chunk) < clip_len:
            chunk.append(chunk[-1])
        masks, clip_labels, clip_scores = run_clip(np.stack(chunk)[None])
        per_frame_masks.append(masks[: min(clip_len, n - start)])
        # the reference takes each tube's label and score from the first
        # clip alone; a later clip's top-k may order its tubes otherwise,
        # and its masks are still matched by position
        if labels is None:
            labels, scores = clip_labels, clip_scores
    return np.concatenate(per_frame_masks, axis=0), labels, scores


def clip_runner(model, cfg, hw: tuple[int, int], stats: list | None = None):
    """`video_prediction`'s `run_clip` for a `KNetVIS` on its device: the
    forward and `vis_decode(out_hw=hw)`, the decode copied to the host;
    `stats` (optional) gets time.perf_counter() after each clip."""
    from video_knet_tpu_torch.models.vis.knet_vis import vis_decode

    device = next(model.parameters()).device

    @torch.inference_mode()
    def run_clip(clip: np.ndarray):
        pred = vis_decode(model(torch.from_numpy(clip).to(device)), cfg, out_hw=hw)
        out = [x.cpu().numpy() for x in (pred.masks, pred.labels, pred.scores)]
        if stats is not None:
            stats.append(time.perf_counter())
        return out

    return run_clip


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--ann-file", required=True)
    p.add_argument("--img-root", default=None)
    p.add_argument("--checkpoint", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--out", required=True)
    p.add_argument("--clip-len", type=int, default=8)
    p.add_argument("--size", type=int, nargs=2, default=[360, 640])
    p.add_argument("--score-thr", type=float, default=0.0)
    return p.parse_args(argv)


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() after each
    clip's decode reaches the host."""
    args = parse_args(argv)
    from video_knet_tpu_torch.config_vis import youtube_vis_2019_config
    from video_knet_tpu_torch.data.ytvis import (
        YouTubeVISDataset,
        format_vis_results,
        tracks_from_prediction,
    )
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS

    device = _cli.setup_device(args.device)
    cfg = youtube_vis_2019_config()
    ds = YouTubeVISDataset(args.ann_file, img_root=args.img_root)
    h, w = args.size
    run_clip = clip_runner(_cli.build_model(KNetVIS, cfg, device, args.checkpoint), cfg,
                           (h, w), stats)
    all_tracks = []
    t0 = time.time()
    for vi, video in enumerate(ds.videos):
        masks, labels, scores = video_prediction(run_clip, video_frames(ds, video, (h, w)),
                                                 args.clip_len)
        all_tracks.append(tracks_from_prediction(
            video.video_id, masks, labels, scores, ds.cat_ids, score_thr=args.score_thr))
        if (vi + 1) % 20 == 0:
            print(f"{vi + 1}/{len(ds)} videos, {(vi + 1) / (time.time() - t0):.2f} vids/s")

    path = format_vis_results(all_tracks, args.out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
