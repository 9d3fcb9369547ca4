"""The trained-weights serving golden, for the port: config, frames, weights.

Own copy of what `tests/trained_golden_common.py` defines, without JAX and
without PIL, so it runs wherever the port runs (the CPU tests and
`chip_smoke.py` on the card):

- `tiny_cfg()`: the 6.9 M-parameter VideoKNet (MiT-b0 backbone, 64-channel
  heads, 20 proposals) with every score and tracker threshold at its
  release default;
- `eval_frames()`: the 12-frame instance-lifecycle sequence (A persists, B
  leaves after frame 5 and expires from the memo, C is born at frame 8),
  drawn directly as uint8 (the reference writes it as lossless PNG), then
  normalized with the ImageNet mean and std; `write_sequence()` writes it,
  with its panoptic GT, as a KITTI-STEP tree;
- `load_weights()` / `tiny_model()`: the committed fp16 checkpoint
  `tests/golden/serving_trained_tiny_fp16.npz` reloaded as fp32 through
  `utils/convert.py`;
- `flatten_results()` / `track_id_spans()`: the golden's comparison surface
  (`tests/golden/serving_trained_tiny_64x96.npz`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from video_knet_tpu_torch.config import (
    ConvKernelHeadConfig,
    KernelUpdateHeadConfig,
    KernelUpdatorConfig,
    TestCfg,
    TrackHeadConfig,
    VideoKNetConfig,
)
from video_knet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS = os.path.join(_ROOT, "tests", "golden", "serving_trained_tiny_fp16.npz")
GOLDEN = os.path.join(_ROOT, "tests", "golden", "serving_trained_tiny_64x96.npz")

HW = (64, 96)
N_FRAMES = 12
# instance script (frame ranges, inclusive)
A_FRAMES = (0, N_FRAMES - 1)
B_FRAMES = (0, 5)
C_FRAMES = (8, N_FRAMES - 1)



def tiny_cfg() -> VideoKNetConfig:
    """MiT-b0, 64-channel heads, 20 proposals; TestCfg and TrackerConfig at
    their defaults except max_per_img (the proposal count)."""
    upd = KernelUpdatorConfig(in_channels=64, feat_channels=64, out_channels=64)
    head = KernelUpdateHeadConfig(in_channels=64, out_channels=64, feedforward_channels=256,
                                  updator=upd, mask_upsample_stride=4)
    rpn = ConvKernelHeadConfig(num_proposals=20, in_channels=64, out_channels=64,
                               fpn_feat_channels=64, feat_downsample_stride=4,
                               seg_use_sigmoid=False, loss_rank_weight=0.1)
    trk = TrackHeadConfig(in_channels=64, fc_out_channels=64, embed_channels=64)
    return VideoKNetConfig(max_insts=4, num_proposals=20, backbone="mit_b0",
                           link_previous=True, rpn=rpn, head=head, track=trk,
                           test=TestCfg(max_per_img=20))


def _blobs(f: int) -> list[tuple[int, int, int, int, tuple[int, int, int]]]:
    """Frame f's instances: (y0, x0, class, instance id, colour)."""
    w = HW[1]
    bw = 28
    # A: person, top row, left -> right
    xa = 2 + int((w - bw - 4) * f / (N_FRAMES - 1))
    blobs = [(2, xa, 11, 1, (200, 40, 40))]
    if B_FRAMES[0] <= f <= B_FRAMES[1]:
        # B: person, bottom row, right -> left
        xb = (w - bw - 2) - int((w - bw - 4) * f / (N_FRAMES - 1))
        blobs.append((36, xb, 11, 2, (40, 160, 220)))
    if C_FRAMES[0] <= f <= C_FRAMES[1]:
        # C: car, bottom row, slight motion
        xc = 20 + 3 * (f - C_FRAMES[0])
        blobs.append((36, xc, 13, 3, (230, 210, 60)))
    return blobs


def sequence_images() -> list[np.ndarray]:
    """The 12 [H, W, 3] uint8 frames of the lifecycle script."""
    bh, bw = 24, 28
    frames = []
    for f in range(N_FRAMES):
        img = np.full((*HW, 3), 90, np.uint8)
        for y0, x0, _, _, color in _blobs(f):
            img[y0:y0 + bh, x0:x0 + bw] = color
        frames.append(img)
    return frames


def write_sequence(root: str) -> str:
    """The lifecycle script as a KITTI-STEP tree under `root`
    (`video_sequence/train`: RGB frames and `kitti_rgb` panoptic PNGs, road
    everywhere else), written with the port's own PNG writer; the same files
    as `tests/trained_golden_common.py:write_sequence` writes with PIL."""
    from video_knet_tpu_torch.data.panoptic_png import save_png

    d = os.path.join(root, "video_sequence", "train")
    os.makedirs(d, exist_ok=True)
    bh, bw = 24, 28
    for f, img in enumerate(sequence_images()):
        pan = np.zeros((*HW, 3), np.uint8)  # road (class 0) everywhere
        for y0, x0, cls, inst, _ in _blobs(f):
            pan[y0:y0 + bh, x0:x0 + bw, 0] = cls
            pan[y0:y0 + bh, x0:x0 + bw, 2] = inst
        save_png(os.path.join(d, f"000000_{f:06d}_leftImg8bit.png"), img)
        save_png(os.path.join(d, f"000000_{f:06d}_panoptic.png"), pan)
    return root


def eval_frames() -> list[np.ndarray]:
    """Normalized [1, H, W, 3] float32 frames, in sequence order."""
    return [((img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD)[None]
            for img in sequence_images()]


def load_weights(path: str = WEIGHTS) -> dict[str, np.ndarray]:
    """The flat {"params/...": array} checkpoint, fp16 leaves as fp32."""
    z = np.load(path)
    return {k: z[k].astype(np.float32) if z[k].dtype == np.float16 else z[k]
            for k in z.files}


def tiny_model(device) -> torch.nn.Module:
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.utils.convert import load_flax_variables

    return load_flax_variables(VideoKNet(tiny_cfg(), device=device), load_weights())


def run_pipeline(model, frames, tracker_type: str = "quasi_dense", device=None) -> list:
    """Online serving of `frames` at release thresholds."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline

    pipe = VPSInferencePipeline(model, tiny_cfg(), HW, tracker_type=tracker_type,
                                device=device)
    return [pipe.run_frame(f, is_first=(i == 0)) for i, f in enumerate(frames)]


def flatten_results(results) -> dict[str, np.ndarray]:
    """Per-frame maps and sorted segments_info columns (the golden's schema)."""
    arrs = {}
    for i, r in enumerate(results):
        arrs[f"pan_{i}"] = np.asarray(r.panoptic_seg, np.int32)
        arrs[f"sem_{i}"] = np.asarray(r.semantic_map, np.int32)
        arrs[f"trk_{i}"] = np.asarray(r.track_map, np.int64)
        segs = sorted(r.segments_info, key=lambda s: s["id"])
        arrs[f"seg_ids_{i}"] = np.array([s["id"] for s in segs], np.int64)
        arrs[f"seg_cat_{i}"] = np.array([s["category_id"] for s in segs], np.int64)
        arrs[f"seg_isthing_{i}"] = np.array([bool(s["isthing"]) for s in segs], bool)
        arrs[f"seg_score_{i}"] = np.array([float(s.get("score", 0.0)) for s in segs],
                                          np.float32)
    return arrs


def track_id_spans(arrs: dict) -> dict[int, tuple[int, int, int]]:
    """{track_id: (first_frame, last_frame, frames_present)}."""
    spans: dict = {}
    for i in range(N_FRAMES):
        for tid in np.unique(arrs[f"trk_{i}"]):
            if tid <= 0:
                continue
            f0, f1, n = spans.get(int(tid), (i, i, 0))
            spans[int(tid)] = (min(f0, i), max(f1, i), n + 1)
    return spans

