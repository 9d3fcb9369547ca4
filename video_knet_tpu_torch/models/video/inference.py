"""Online VPS serving: the quasi-dense tracker on the device, or any of the
host trackers.

Counterpart of `video_knet_tpu/models/video/inference.py` for every
`tracker_type` the reference serves:

- device tracker (`quasi_dense` with `fast_decode`): one device step a frame
  runs the forward, linking, panoptic decode, semantic filter, box
  extraction, association and memo update; the host only nearest-upsamples
  the id map and formats segments_info. Carried state: the previous frame's
  final kernels and the `TrackerState`.
- host tracker (`quasi_dense_host`, and `quasi_dense` with
  `fast_decode=False`, as the reference falls back): the device step
  decodes and ships a payload, and the numpy `QuasiDenseEmbedTracker` runs in
  `_finish_frame`. With `fast_decode` the payload is compact (the id map at
  merge resolution, embeddings as bf16 on the wire); without it the decode
  runs at `out_hw` with the bilinear upsample before the merge.
- the other host trackers, on the same payload: `tao` (`tao_tracker.py`),
  `unitrack` (`unitrack.py`: its embeddings are pooled from a frozen
  appearance encoder's features, `appearance_fn`, which ride in the frame's
  payload as `app_feat`; without one it pools nothing and takes the track
  head's embeddings), `simple` and `overlap` (`tracker_variants.py`).
- `run_sequence`: windows of W frames enqueued back to back, one
  device->host copy of the stacked payloads a window, drained on worker
  threads while the next window is enqueued.
- Every payload crosses to the host as one packed buffer in one copy
  (`utils/tree.py`: `pack`, `HostCopy`), as the reference's one
  `jax.device_get` a frame.
- `MultiStreamVPSPipeline`: B streams through one batched step a round.

The serving path runs in full float32 (TF32 off for cuBLAS and cuDNN).
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from video_knet_tpu_torch.config import VideoKNetConfig
from video_knet_tpu_torch.data.transforms import nearest_resize
from video_knet_tpu_torch.models.layers import resize_nearest
from video_knet_tpu_torch.models.video import device_tracker as dt
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet, vps_decode
from video_knet_tpu_torch.models.video.tao_tracker import TaoTracker
from video_knet_tpu_torch.models.video.tracker import QuasiDenseEmbedTracker, masks_to_boxes
from video_knet_tpu_torch.models.video.tracker_variants import OverlapTracker, SimpleMaskTracker
from video_knet_tpu_torch.models.video.unitrack import MaskAssociationTracker, mask_pool_embeddings
from video_knet_tpu_torch.ops.panoptic import PanopticResult, segments_to_host
from video_knet_tpu_torch.utils.device import resolve_device, set_fp32_numerics
from video_knet_tpu_torch.utils.profiling import span
from video_knet_tpu_torch.utils.tree import HostCopy, to_host, tree_index, tree_stack

# KITTI-STEP: the 2 thing classes sit at indices 11 (person) and 13 (car) of
# the 19-class cityscapes label space.
KITTI_STEP_THING_IDS = (11, 13)
TRACKER_TYPES = ("quasi_dense", "quasi_dense_host", "tao", "unitrack", "simple", "overlap")


def _track_embed_dim(cfg: VideoKNetConfig) -> int:
    """Width of the test-time track embeddings (the device tracker's state)."""
    if cfg.track_head_type == "query_fuse":
        return cfg.track.query_fc_out_channels
    return cfg.track.embed_channels


def _flags_tensor(is_first, device) -> torch.Tensor:
    """[B] per-stream `is_first` flags (host bools) as a device tensor."""
    return torch.tensor([bool(f) for f in is_first], dtype=torch.bool, device=device)


def _semantic_thing(out: dict, pan_hw, cfg: VideoKNetConfig, batched: bool) -> torch.Tensor:
    """Semantic filter: argmax of the seg logits at feature resolution,
    nearest-resized to the id map, below the thing-class count."""
    seg = out["rpn_out"].seg_preds if batched else out["rpn_out"].seg_preds[0]
    sem_label = torch.argmax(seg, dim=-1).to(torch.int32)
    return resize_nearest(sem_label, tuple(pan_hw)) < cfg.num_thing_classes


def make_device_tracker_frame_step(model: VideoKNet, cfg: VideoKNetConfig, out_hw,
                                   thing_ids_in_orig=KITTI_STEP_THING_IDS,
                                   batched: bool = False):
    """step(img, prev_obj_feats, track_state, is_first) -> dict(payload...,
    new_obj_feats, track_state). The id maps stay at merge resolution
    (requires fast_decode).

    batched=True serves B streams: `img` [B, H, W, 3], `track_state` stacked
    along a leading [B] axis, `is_first` a [B] sequence of host bools; the
    association runs stream by stream (the reference vmaps it)."""
    if not cfg.test.fast_decode:
        raise ValueError("the device tracker requires cfg.test.fast_decode")
    device = next(model.parameters()).device
    cls_table = torch.as_tensor(
        dt.dataset_class_table(cfg.num_thing_classes, cfg.num_stuff_classes,
                               thing_ids_in_orig), device=device)
    kth = cfg.test.max_per_img

    def decoded(res):
        """One stream's payload but its track LUT: casts and the class LUT."""
        ktot = res.seg_ids.shape[0]
        cls_of = cls_table[res.labels.long()]
        lut_s = torch.zeros(ktot + 1, dtype=torch.int32, device=res.seg_ids.device)
        lut_s[torch.where(res.keep, res.seg_ids, 0).long()] = torch.where(res.keep, cls_of, 0)
        pan_dtype = torch.uint8 if ktot <= 255 else torch.int16
        return dict(
            pan=res.panoptic_seg.to(pan_dtype),
            lut_sem=lut_s.to(torch.int16),
            keep=res.keep, seg_ids=res.seg_ids.to(torch.int16),
            labels=res.labels.to(torch.int16), scores=res.scores,
            isthing=res.isthing, areas=res.areas,
            instance_idx=res.instance_idx.to(torch.int16),
        )

    def tracked(pred, emb, semth, st, isf):
        """One stream's association -> (track LUT, new state)."""
        res = pred.result
        pan = res.panoptic_seg
        valid = res.keep[:kth] & res.isthing[:kth]
        sy = out_hw[0] / pan.shape[0]
        sx = out_hw[1] / pan.shape[1]
        boxes5 = dt.thing_detections_from_decode(
            pan, res.seg_ids[:kth], valid, res.scores[:kth], semth, (sy, sx))
        det_emb = emb[pred.thing_mask_idx]  # [kth, D] source-proposal embeds
        st = dt.reset_state(st, isf)
        st, ids, survived = dt.tracker_match(
            st, boxes5, res.labels[:kth], det_emb, valid, cfg.tracker)
        # host id convention: +1, suppressed/unassigned -> 0
        tid = torch.clamp(ids + 1, min=0) * survived.to(torch.int32)
        # every write to row 0 carries 0, so duplicate indices agree
        lut_t = torch.zeros(res.seg_ids.shape[0] + 1, dtype=torch.int32, device=pan.device)
        lut_t[torch.where(tid > 0, res.seg_ids[:kth], 0).long()] = tid
        return lut_t, st

    @torch.inference_mode()
    def step(img, prev_obj_feats, track_state, is_first):
        isf = _flags_tensor(is_first, img.device) if batched else bool(is_first)
        out = model.test_step(img, prev_obj_feats, isf)
        with span("vk.serve.decode"):
            pred = vps_decode(out["rpn_out"], out["stage_outs"], out["track_obj_feats"], cfg,
                              None, batched=batched)
            semth = _semantic_thing(out, pred.result.panoptic_seg.shape[-2:], cfg, batched)
            if batched:
                preds = [tree_index(pred, i) for i in range(len(is_first))]
                payload = tree_stack([decoded(p.result) for p in preds])
            else:
                payload = decoded(pred.result)
        with span("vk.serve.track"):
            if batched:
                per = [tracked(preds[i], out["track_embeds"][i], semth[i],
                               tree_index(track_state, i), bool(f))
                       for i, f in enumerate(is_first)]
                lut_t = torch.stack([lut for lut, _ in per])
                st = tree_stack([s for _, s in per])
            else:
                lut_t, st = tracked(pred, out["track_embeds"][0], semth, track_state, isf)
        payload["lut_track"] = lut_t
        payload["new_obj_feats"] = out["new_obj_feats"]
        payload["track_state"] = st
        return payload

    return step


def make_frame_step(model: VideoKNet, cfg: VideoKNetConfig, out_hw, batched: bool = False,
                    compact_host: bool = False):
    """step(img, prev_obj_feats, is_first) -> payload dict for the host
    tracker, with `new_obj_feats`.

    compact_host=True (fast_decode only) keeps the id map at merge
    resolution and ships only what `_finish_frame` reads, the embeddings as
    bf16; otherwise the decode runs at `out_hw` (bilinear before the merge)
    and the whole `PanopticPrediction` ships. batched=True serves B streams
    (`is_first` a [B] sequence of host bools)."""

    @torch.inference_mode()
    def step(img, prev_obj_feats, is_first):
        isf = _flags_tensor(is_first, img.device) if batched else bool(is_first)
        out = model.test_step(img, prev_obj_feats, isf)
        with span("vk.serve.decode"):
            decode_hw = None if compact_host else out_hw
            pred = vps_decode(out["rpn_out"], out["stage_outs"], out["track_obj_feats"], cfg,
                              decode_hw, batched=batched)
            semantic_thing = _semantic_thing(out, pred.result.panoptic_seg.shape[-2:], cfg,
                                             batched)
            emb = out["track_embeds"] if batched else out["track_embeds"][0]
            if compact_host:
                res = pred.result
                return dict(
                    pan=res.panoptic_seg.to(torch.int16),  # ids < 2^15 always
                    keep=res.keep, seg_ids=res.seg_ids.to(torch.int16),
                    labels=res.labels.to(torch.int16), scores=res.scores,
                    isthing=res.isthing, areas=res.areas,
                    instance_idx=res.instance_idx.to(torch.int16),
                    thing_mask_idx=pred.thing_mask_idx.to(torch.int16),
                    # bf16 on the wire (round to nearest even, as XLA's cast);
                    # the host re-floats
                    embeds=emb.to(torch.bfloat16),
                    semantic_thing=semantic_thing,
                    new_obj_feats=out["new_obj_feats"],
                )
            return dict(pred=pred, embeds=emb, semantic_thing=semantic_thing,
                        new_obj_feats=out["new_obj_feats"])

    return step


def _pipelined(steps, finish, *, window: int, depth: int, workers: int,
               frames_per_item: int, stats: list | None):
    """The windowed serving loop shared by `run_sequence` and
    `run_batched_sequence`; yields `finish(host_payload, meta)` per item, in
    order.

    `steps` yields (barrier, run) pairs: `run()` enqueues one device step and
    returns (payload, meta); a barrier first drains everything in flight.
    Every `window` items the payloads are stacked on the device and packed
    into one buffer whose copy to pinned host memory is enqueued, from this
    thread, behind the window's steps; a worker thread waits on that copy's
    event only, then finishes the items. At most `depth` windows stay in
    flight.

    Spans (`utils/profiling.py`), all on this thread and none open across a
    `yield`: pulling the next item from `steps`, each `run()`, each window's
    pack and copy, and each wait on a drain."""
    pending: collections.deque = collections.deque()  # of Futures
    buf: list = []
    steps = iter(steps)

    def drain(copy, metas):
        host = copy.result()
        t0 = time.perf_counter()
        out = [finish(tree_index(host, i), m) for i, m in enumerate(metas)]
        if stats is not None:
            stats.append({"host_s": time.perf_counter() - t0,
                          "frames": len(out) * frames_per_item})
        return out

    def flush():
        with span("vk.serve.pack"):
            copy = HostCopy(tree_stack([p for p, _ in buf]))
            pending.append(pool.submit(drain, copy, [m for _, m in buf]))
            buf.clear()

    def drained():
        with span("vk.serve.wait_result"):
            return pending.popleft().result()

    pool = ThreadPoolExecutor(max_workers=workers)
    try:
        while True:
            with span("vk.serve.wait_input"):
                item = next(steps, None)
            if item is None:
                break
            barrier, run = item
            if barrier:
                if buf:
                    flush()
                while pending:
                    yield from drained()
            with span("vk.serve.round"):
                buf.append(run())
            if len(buf) >= max(window, 1):
                flush()
                while len(pending) > max(depth, 1):
                    yield from drained()
        if buf:
            flush()
        while pending:
            yield from drained()
    finally:
        pool.shutdown(wait=True)


@dataclass
class VPSResult:
    panoptic_seg: np.ndarray
    segments_info: list
    semantic_map: np.ndarray
    track_map: np.ndarray


def semantic_map_from_panoptic(
    pan: np.ndarray,
    segments_info: list,
    *,
    num_thing_classes: int,
    num_stuff_classes: int,
    thing_ids_in_orig: tuple[int, ...] | None = KITTI_STEP_THING_IDS,
) -> np.ndarray:
    """Panoptic ids -> dataset-label-space semantic map.

    thing_ids_in_orig given (KITTI-STEP style): thing k -> thing_ids_in_orig[k];
    stuff (1-based cat) -> its original index skipping thing slots.
    None: the dataset space is the things-first space: thing -> cat;
    stuff -> cat - 1 + num_thing.
    """
    # segment-id -> class lookup table, then one gather over the id map
    max_id = max((seg["id"] for seg in segments_info), default=0)
    lut = np.zeros(max_id + 1, np.int32)
    for seg in segments_info:
        if seg["isthing"]:
            if thing_ids_in_orig is not None:
                cls = thing_ids_in_orig[seg["category_id"]]
            else:
                cls = seg["category_id"]
        else:
            cat = seg["category_id"] - 1
            if thing_ids_in_orig is not None:
                offset = 0
                for tid in thing_ids_in_orig:
                    if cat + offset >= tid:
                        offset += 1
                cls = cat + offset
            else:
                cls = cat + num_thing_classes
        lut[seg["id"]] = cls
    return lut[np.minimum(pan, max_id)]


class VPSInferencePipeline:
    """Carries per-video state; call `run_frame` for each frame in order, or
    `run_sequence` over a whole sequence.

    tracker_type: 'quasi_dense' (the tracker on the device; with
    fast_decode=False it runs on the host, as in the reference),
    'quasi_dense_host' (the numpy tracker), 'tao', 'unitrack', 'simple' or
    'overlap' (host trackers; anything else raises ValueError).
    `appearance_fn` (with 'unitrack'): img [1, H, W, 3] on the device ->
    [1, h, w, C] appearance features (`appearance.make_appearance_fn`), which
    ride in the frame's payload. `device` defaults to CUDA and must be where
    `model` lives. `step_fn` lets `MultiStreamVPSPipeline` share one batched
    step; such a pipeline only holds a stream's host state for
    `_finish_frame`."""

    def __init__(self, model: VideoKNet, cfg: VideoKNetConfig, out_hw,
                 thing_ids_in_orig=KITTI_STEP_THING_IDS, tracker_type: str = "quasi_dense",
                 device: str | torch.device | None = None, step_fn=None,
                 appearance_fn=None):
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type:
            raise ValueError(f"model lives on {model_device}, pipeline asked for {self.device}")
        set_fp32_numerics()
        self.cfg = cfg
        self.out_hw = tuple(out_hw)
        self.thing_ids_in_orig = thing_ids_in_orig
        self.tracker_type = tracker_type
        self.appearance_fn = appearance_fn
        # the device tracker needs the id maps at merge resolution
        # (fast_decode); without it the host tracker takes over
        self.device_tracker = tracker_type == "quasi_dense" and cfg.test.fast_decode
        if step_fn is not None:
            self.step = step_fn
        elif self.device_tracker:
            self.step = make_device_tracker_frame_step(model, cfg, out_hw, thing_ids_in_orig)
        else:
            self.step = make_frame_step(model, cfg, out_hw, compact_host=cfg.test.fast_decode)
        n_tot = cfg.num_proposals + cfg.num_stuff_classes
        k = cfg.head.conv_kernel_size ** 2
        self._zero_obj = torch.zeros((1, n_tot, k, cfg.head.in_channels),
                                     dtype=torch.float32, device=model_device)
        self.reset()

    def _make_tracker(self):
        if self.device_tracker:
            return None  # the association state is `track_state`
        if self.tracker_type in ("quasi_dense", "quasi_dense_host"):
            return QuasiDenseEmbedTracker(self.cfg.tracker)
        if self.tracker_type == "tao":
            return TaoTracker()
        if self.tracker_type == "unitrack":
            return MaskAssociationTracker()
        if self.tracker_type == "overlap":
            return OverlapTracker()
        if self.tracker_type == "simple":
            return SimpleMaskTracker()
        raise ValueError(f"unknown tracker_type {self.tracker_type!r}; one of {TRACKER_TYPES}")

    def reset(self):
        self.tracker = self._make_tracker()
        self.prev_obj_feats = self._zero_obj
        self.frame_id = 0
        if self.device_tracker:
            self.track_state = dt.init_tracker_state(
                self.cfg.tracker, self.cfg.test.max_per_img, _track_embed_dim(self.cfg),
                device=self._zero_obj.device)

    def _to_device(self, img) -> torch.Tensor:
        with span("vk.serve.h2d"):
            return torch.as_tensor(img, dtype=torch.float32).to(self._zero_obj.device)

    def _step(self, img: torch.Tensor, is_first: bool) -> dict:
        """One device step (either tracker path); updates the carried state."""
        if self.device_tracker:
            out = self.step(img, self.prev_obj_feats, self.track_state, bool(is_first))
            self.track_state = out.pop("track_state")
        else:
            out = self.step(img, self.prev_obj_feats, bool(is_first))
        self.prev_obj_feats = out.pop("new_obj_feats")
        if self.appearance_fn is not None and self.tracker_type == "unitrack":
            # rides in the same packed copy as the rest of the payload
            out["app_feat"] = torch.as_tensor(self.appearance_fn(img), dtype=torch.float32,
                                              device=img.device)
        return out

    def run_frame(self, img, is_first: bool) -> VPSResult:
        """img: [1, H, W, 3] float32 (tensor or numpy), normalized."""
        if is_first:
            self.reset()
        payload = self._step(self._to_device(img), is_first)
        return self._finish_frame(to_host(payload))

    def run_sequence(self, frames, is_first_flags=None, window: int = 8, depth: int = 1,
                     stats: list | None = None):
        """Pipelined online inference over an iterable of frames; yields one
        VPSResult per frame, in order, equal to `run_frame`'s.

        `window` frames are enqueued back to back, then their payloads are
        stacked on the device and cross to the host in one copy. `depth`
        windows stay in flight before the oldest is drained. The drain (copy
        + `_finish_frame`) of a window runs on a worker thread while the main
        thread enqueues the next: two workers with the device tracker (the
        finish is pure formatting), one with the host tracker (it is
        stateful and must see frames in order). A sequence boundary
        (`is_first` after the first frame) drains everything in flight, then
        resets. stats: optional list, appended one {'host_s', 'frames'}
        dict per drained window (host_s: the finish's seconds, after the
        copy)."""
        def steps():
            for i, img in enumerate(frames):
                is_first = (i == 0) if is_first_flags is None else bool(is_first_flags[i])

                def run(img=img, is_first=is_first):
                    # after a boundary's drain: the host-side state is reset
                    # only once every window in flight has finished
                    if is_first:
                        self.reset()
                    return self._step(self._to_device(img), is_first), None

                yield is_first and i > 0, run

        yield from _pipelined(steps(), lambda host, _: self._finish_frame(host), window=window,
                              depth=depth, workers=2 if self.device_tracker else 1,
                              frames_per_item=1, stats=stats)

    def _finish_frame(self, host: dict) -> VPSResult:
        """Host side of a frame, from its fetched (numpy) payload."""
        if "lut_track" in host:
            # device-tracker payload: segments_info, one nearest upsample of
            # the id map, then the track/semantic LUT gathers. No frame_id
            # increment: this branch is pure formatting and may run on two
            # drain workers at once.
            res = PanopticResult(
                panoptic_seg=np.asarray(host["pan"], np.int32),
                keep=host["keep"],
                seg_ids=np.asarray(host["seg_ids"], np.int32),
                labels=np.asarray(host["labels"], np.int32),
                scores=host["scores"],
                isthing=host["isthing"],
                areas=host["areas"],
                instance_idx=np.asarray(host["instance_idx"], np.int32),
            )
            pan, segments_info = segments_to_host(res, self.cfg.num_thing_classes)
            if pan.shape != self.out_hw:
                pan = nearest_resize(pan, self.out_hw)
            pan_c = np.minimum(pan, len(host["lut_sem"]) - 1)
            sem = np.asarray(host["lut_sem"], np.int32)[pan_c]
            track_map = np.asarray(host["lut_track"], np.int32)[pan_c]
            return VPSResult(pan, segments_info, sem, track_map)

        if "pred" in host:  # full payload (fast_decode=False: decoded at out_hw)
            p = host["pred"]
            res = PanopticResult(*[np.asarray(x) for x in p.result])
            res = res._replace(
                panoptic_seg=res.panoptic_seg.astype(np.int32),
                seg_ids=res.seg_ids.astype(np.int32),
                labels=res.labels.astype(np.int32),
                instance_idx=res.instance_idx.astype(np.int32),
            )
            thing_mask_idx = np.asarray(p.thing_mask_idx, np.int32)
        else:  # compact payload
            res = PanopticResult(
                panoptic_seg=np.asarray(host["pan"], np.int32),
                keep=np.asarray(host["keep"]),
                seg_ids=np.asarray(host["seg_ids"], np.int32),
                labels=np.asarray(host["labels"], np.int32),
                scores=np.asarray(host["scores"]),
                isthing=np.asarray(host["isthing"]),
                areas=np.asarray(host["areas"]),
                instance_idx=np.asarray(host["instance_idx"], np.int32),
            )
            thing_mask_idx = np.asarray(host["thing_mask_idx"], np.int32)
        pan, segments_info = segments_to_host(res, self.cfg.num_thing_classes)
        semantic_thing = np.asarray(host["semantic_thing"], dtype=np.float32)
        embeds = np.asarray(host["embeds"], dtype=np.float32)
        oh, ow = self.out_hw
        sy, sx = oh / pan.shape[0], ow / pan.shape[1]

        # kept things: boxes from the filtered masks, then the host tracker
        thing_sel = np.nonzero(res.keep & res.isthing)[0]
        track_map = np.zeros(pan.shape, np.float64)
        if len(thing_sel) > 0:
            masks = np.stack([pan == int(res.seg_ids[k]) for k in thing_sel])
            labels = res.labels[thing_sel]
            scores = res.scores[thing_sel]
            # candidate k indexes the top-k thing list; its embedding comes
            # from its source proposal (thing_mask_idx)
            inst = res.instance_idx[thing_sel]
            det_embeds = embeds[thing_mask_idx[inst]]
            filt = masks * semantic_thing[None]
            # boxes in out_hw coordinates (scale-consistent across frames)
            boxes = masks_to_boxes(filt) * np.array([sx, sy, sx, sy])
            bboxes5 = np.concatenate([boxes, scores[:, None]], axis=1)
            if self.tracker_type in ("quasi_dense", "quasi_dense_host", "tao"):
                sel, _, ids = self.tracker.match(bboxes5, labels, det_embeds, self.frame_id)
                ids = ids + 1
                ids[ids == -1] = 0  # suppressed (-2 + 1) -> 0
            elif self.tracker_type == "unitrack":
                if "app_feat" in host:
                    # the frozen encoder's features pooled under each
                    # candidate's mask at merge resolution
                    det_embeds = mask_pool_embeddings(
                        np.asarray(host["app_feat"][0], np.float32), filt > 0.5)
                ids = self.tracker.step(filt.astype(bool), det_embeds, scores)
                sel = np.arange(len(ids))
            else:  # simple / overlap
                ids = self.tracker.step(filt.astype(bool), scores)
                sel = np.arange(len(ids))
            for src, tid in zip(sel, ids):
                if tid > 0:
                    track_map[masks[src].astype(bool)] = tid

        sem = semantic_map_from_panoptic(
            pan, segments_info,
            num_thing_classes=self.cfg.num_thing_classes,
            num_stuff_classes=self.cfg.num_stuff_classes,
            thing_ids_in_orig=self.thing_ids_in_orig,
        )
        self.frame_id += 1
        if pan.shape != (oh, ow):
            pan = nearest_resize(pan, (oh, ow))
            sem = nearest_resize(sem, (oh, ow))
            track_map = nearest_resize(track_map, (oh, ow))
        return VPSResult(pan, segments_info, sem, track_map)


class MultiStreamVPSPipeline:
    """Online VPS over B independent video streams with one batched device
    step a round.

    Frame t of every stream runs in one step (batched backbone, heads and
    decode; the association stream by stream, on the device or the host).
    Streams reset independently through the per-stream `is_first` flags:
    first-frame rows zero their carried kernels inside the step. `device`
    defaults to CUDA and must be where `model` lives. host_workers > 0 runs
    the per-stream `_finish_frame`s of a round on a thread pool."""

    def __init__(self, model: VideoKNet, cfg: VideoKNetConfig, out_hw, n_streams: int,
                 thing_ids_in_orig=KITTI_STEP_THING_IDS, tracker_type: str = "quasi_dense",
                 host_workers: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n = n_streams
        self._pool = ThreadPoolExecutor(max_workers=host_workers) if host_workers > 0 else None
        self.device_tracker = tracker_type == "quasi_dense" and cfg.test.fast_decode
        if self.device_tracker:
            self.step = make_device_tracker_frame_step(model, cfg, out_hw, thing_ids_in_orig,
                                                       batched=True)
            one = dt.init_tracker_state(cfg.tracker, cfg.test.max_per_img,
                                        _track_embed_dim(cfg), device=self.device)
            self.track_state = tree_stack([one] * n_streams)
        else:
            self.step = make_frame_step(model, cfg, out_hw, batched=True,
                                        compact_host=cfg.test.fast_decode)
        # per-stream host state (tracker, frame counter) shares the one step
        self.streams = [
            VPSInferencePipeline(model, cfg, out_hw, thing_ids_in_orig=thing_ids_in_orig,
                                 tracker_type=tracker_type, device=self.device,
                                 step_fn=self.step)
            for _ in range(n_streams)
        ]
        n_tot = cfg.num_proposals + cfg.num_stuff_classes
        k = cfg.head.conv_kernel_size ** 2
        self.prev_obj = torch.zeros((n_streams, n_tot, k, cfg.head.in_channels),
                                    dtype=torch.float32, device=self.device)

    def close(self) -> None:
        """Stop the host worker threads (if any)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _finish_round(self, host: dict, flags) -> list[VPSResult]:
        for i in range(self.n):
            if flags[i]:
                self.streams[i].tracker = self.streams[i]._make_tracker()
                self.streams[i].frame_id = 0
        if self._pool is not None:
            return list(self._pool.map(
                lambda i: self.streams[i]._finish_frame(tree_index(host, i)), range(self.n)))
        return [self.streams[i]._finish_frame(tree_index(host, i)) for i in range(self.n)]

    def _step(self, imgs, flags) -> dict:
        with span("vk.serve.h2d"):
            imgs = torch.as_tensor(imgs, dtype=torch.float32).to(self.device)
        if self.device_tracker:
            out = self.step(imgs, self.prev_obj, self.track_state, flags)
            self.track_state = out.pop("track_state")
        else:
            out = self.step(imgs, self.prev_obj, flags)
        self.prev_obj = out.pop("new_obj_feats")
        return out

    def run_frames(self, imgs, is_first_flags) -> list[VPSResult]:
        """imgs: [B, H, W, 3]; is_first_flags: [B] bools. One result per stream."""
        flags = np.asarray(is_first_flags, bool)
        return self._finish_round(to_host(self._step(imgs, flags)), flags)

    def run_batched_sequence(self, rounds, flags_per_round=None, depth: int = 2,
                             stats: list | None = None, window: int = 4):
        """Pipelined serving loop: `rounds` yields [B, H, W, 3] frame batches;
        yields a list of B VPSResults a round, equal to `run_frames`'.

        `window` rounds are enqueued back to back and their stacked payloads
        cross to the host in one copy; up to `depth` windows stay in flight,
        and each drain (copy + every stream's finish) runs on a worker
        thread (two with the device tracker, one with the stateful host
        tracker). flags_per_round: [T][B] bools, default every stream starts
        at round 0. stats: optional list, appended one {'host_s', 'frames'}
        dict per drained window (host_s: the finish's seconds, after the
        copy)."""
        def steps():
            for t, imgs in enumerate(rounds):
                flags = (np.full((self.n,), t == 0, bool) if flags_per_round is None
                         else np.asarray(flags_per_round[t], bool))
                yield False, lambda imgs=imgs, flags=flags: (self._step(imgs, flags), flags)

        yield from _pipelined(steps(), self._finish_round, window=window, depth=depth,
                              workers=2 if self.device_tracker else 1,
                              frames_per_item=self.n, stats=stats)
