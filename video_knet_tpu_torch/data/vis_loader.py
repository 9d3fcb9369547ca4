"""VIS clip train loader: sampled clips, one shared transform, fixed-slot tubes.

Counterpart of `video_knet_tpu/data/vis_loader.py`, which replaces the
reference's mmtrack Seq* pipeline for YT-VIS training
(configs/video_knet_vis/_base_/datasets/youtubevis_2019.py): a clip of
`cfg.num_frames` frames from one window gets ONE transform draw
(`SeqResize(multiscale_mode='value', img_scale=[(288, 1e6)..(512, 1e6)],
keep_ratio=True)` as a short side drawn from `short_sides`, a shared flip
and crop), and its GT tubes land in fixed slots (`ClipGT`) at the
mask-assign stride.

One canvas shape (`canvas_hw`, padded bottom/right with zeros, the
normalized mean) instead of the reference's per-batch size_divisor=32
padding; content that overflows the canvas is cropped with clip-shared
offsets. The threads, the up-front seeds, the rank striding and the pinned
`non_blocking` copy to `device` are `data/loader.py:ThreadedLoader`'s, so
batches equal JAX's bit for bit at any thread count. Batches are
`train/vis.py:VISBatch` of torch tensors on `device`.

YT-VIS frames are JPEGs: `load_png` reads them through PIL, imported only
for a non-PNG file.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from video_knet_tpu_torch.config_vis import VISConfig
from video_knet_tpu_torch.data.loader import ThreadedLoader
from video_knet_tpu_torch.data.panoptic_png import load_png
from video_knet_tpu_torch.data.transforms import (
    SeqTransformParams,
    _resolve_geometry,
    apply_image_transform,
    bilinear_resize,
    nearest_resize,
)
from video_knet_tpu_torch.data.ytvis import YouTubeVISDataset
from video_knet_tpu_torch.models.vis.knet_vis import ClipGT
from video_knet_tpu_torch.train.vis import VISBatch

# the reference's discrete short-side draw (youtubevis_2019.py SeqResize)
YTVIS_SHORT_SIDES = (288, 320, 352, 392, 416, 448, 480, 512)


def sample_vis_transform_params(
    rng: np.random.RandomState,
    *,
    short_sides: Sequence[int] = YTVIS_SHORT_SIDES,
    flip_prob: float = 0.5,
) -> SeqTransformParams:
    """multiscale_mode='value': one short side from the list, ratio 1.0.

    mmcv's keep_ratio with img_scale=(short, 1e6) gives the factor
    min(1e6 / long_in, short / short_in) = short / short_in."""
    s = int(short_sides[rng.randint(0, len(short_sides))])
    return SeqTransformParams(
        scale=1.0,
        flip=bool(rng.rand() < flip_prob),
        crop_y=float(rng.rand()),
        crop_x=float(rng.rand()),
        img_scale=(s, 10**6),
    )


class VISTrainLoader(ThreadedLoader):
    producer_name = "vis-loader-producer"

    def __init__(
        self,
        dataset: YouTubeVISDataset,
        cfg: VISConfig,
        *,
        batch_size: int = 1,
        canvas_hw: tuple[int, int] = (512, 928),
        short_sides: Sequence[int] = YTVIS_SHORT_SIDES,
        frame_range: tuple[int, int] = (-2, 2),
        seed: int = 0,
        prefetch: int = 2,
        num_threads: int = 4,
        process_index: int | None = None,
        process_count: int | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(seed=seed, prefetch=prefetch, num_threads=num_threads,
                         process_index=process_index, process_count=process_count,
                         device=device)
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.canvas_hw = canvas_hw
        self.short_sides = tuple(short_sides)
        self.frame_range = frame_range

    def _load(self, vid: int, rng: np.random.RandomState):
        cfg = self.cfg
        t = cfg.num_frames
        idxs = self.ds.sample_clip(vid, rng, num_frames=t, frame_range=self.frame_range)
        v = self.ds.videos[vid]
        p = sample_vis_transform_params(rng, short_sides=self.short_sides)
        clip = np.stack([
            apply_image_transform(load_png(self.ds.frame_path(v.frames[fi])), p,
                                  self.canvas_hw)
            for fi in idxs])  # [T, H, W, 3]

        masks, labels, valid = self.ds.clip_gt_arrays(vid, idxs, max_insts=cfg.max_insts)
        # the tubes take the clip's resize, flip and crop (nearest), then
        # the bilinear downsample to the mask-assign stride
        s = cfg.mask_assign_stride
        ah, aw = self.canvas_hw[0] // s, self.canvas_hw[1] // s
        g = masks.shape[0]
        out = np.zeros((g, t, ah, aw), np.float32)
        for gi in range(g):
            if not valid[gi]:
                continue
            for ti in range(t):
                m = _transform_mask(masks[gi, ti], p, self.canvas_hw)
                out[gi, ti] = bilinear_resize(m, (ah, aw))
        return clip, out, labels, valid

    def _assemble(self, items) -> VISBatch:
        """Host batch of a batch's clips (the consumer moves it to the device)."""
        clips, masks, labels, valid = (self._stack(list(x)) for x in zip(*items))
        return VISBatch(clips, ClipGT(masks, labels, valid))

    def _to_device(self, batch: VISBatch) -> VISBatch:
        return VISBatch(self._move(batch.clip), ClipGT(*map(self._move, batch.gt)))


def _transform_mask(mask: np.ndarray, p: SeqTransformParams,
                    canvas_hw: tuple[int, int]) -> np.ndarray:
    """One GT frame through the clip's geometry: nearest resize, flip, crop,
    zero pad to the canvas."""
    (rh, rw), (oy, ox) = _resolve_geometry(mask.shape[:2], canvas_hw, p)
    x = nearest_resize(mask, (rh, rw))
    if p.flip:
        x = x[:, ::-1]
    x = x[oy : oy + canvas_hw[0], ox : ox + canvas_hw[1]]
    out = np.zeros(canvas_hw, mask.dtype)
    out[: x.shape[0], : x.shape[1]] = x
    return out
