"""Online VPS serving: the per-frame step with the on-device tracker.

Counterpart of the `quasi_dense` (device-tracker) path of
`video_knet_tpu/models/video/inference.py`: one device step per frame runs
the forward, linking, panoptic decode, semantic filter, box extraction,
association and memo update; the host only nearest-upsamples the id map
and formats segments_info. Carried state: the previous frame's final
kernels and the `TrackerState`.

The serving path runs in full float32 (TF32 off for cuBLAS and cuDNN).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from video_knet_tpu_torch.config import VideoKNetConfig
from video_knet_tpu_torch.models.layers import resize_nearest
from video_knet_tpu_torch.models.video import device_tracker as dt
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet, vps_decode
from video_knet_tpu_torch.ops.panoptic import PanopticResult, segments_to_host
from video_knet_tpu_torch.utils.device import resolve_device, set_fp32_numerics

# KITTI-STEP: the 2 thing classes sit at indices 11 (person) and 13 (car) of
# the 19-class cityscapes label space.
KITTI_STEP_THING_IDS = (11, 13)


def nearest_resize(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Host nearest resize of a [H, W, ...] array (half-pixel centers)."""
    h, w = arr.shape[:2]
    oh, ow = out_hw
    ys = np.clip(((np.arange(oh) + 0.5) * (h / oh)).astype(np.int64), 0, h - 1)
    xs = np.clip(((np.arange(ow) + 0.5) * (w / ow)).astype(np.int64), 0, w - 1)
    return arr[ys][:, xs]


def make_device_tracker_frame_step(model: VideoKNet, cfg: VideoKNetConfig, out_hw,
                                   thing_ids_in_orig=KITTI_STEP_THING_IDS):
    """step(img, prev_obj_feats, track_state, is_first) -> dict(payload...,
    new_obj_feats, track_state). The id maps stay at merge resolution
    (requires fast_decode)."""
    if not cfg.test.fast_decode:
        raise NotImplementedError(
            "fast_decode=False (bilinear upsampling before the merge, host tracker "
            "payload) is not ported yet (ROADMAP: host-tracker slice)")
    device = next(model.parameters()).device
    cls_table = torch.as_tensor(
        dt.dataset_class_table(cfg.num_thing_classes, cfg.num_stuff_classes,
                               thing_ids_in_orig), device=device)
    kth = cfg.test.max_per_img

    def one_stream(pred, emb, semth, st, isf):
        res = pred.result
        pan = res.panoptic_seg
        valid = res.keep[:kth] & res.isthing[:kth]
        ktot = res.seg_ids.shape[0]
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
        lut_t = torch.zeros(ktot + 1, dtype=torch.int32, device=pan.device)
        lut_t[torch.where(tid > 0, res.seg_ids[:kth], 0).long()] = tid
        cls_of = cls_table[res.labels.long()]
        lut_s = torch.zeros(ktot + 1, dtype=torch.int32, device=pan.device)
        lut_s[torch.where(res.keep, res.seg_ids, 0).long()] = torch.where(res.keep, cls_of, 0)
        pan_dtype = torch.uint8 if ktot <= 255 else torch.int16
        payload = dict(
            pan=pan.to(pan_dtype),
            lut_track=lut_t,
            lut_sem=lut_s.to(torch.int16),
            keep=res.keep, seg_ids=res.seg_ids.to(torch.int16),
            labels=res.labels.to(torch.int16), scores=res.scores,
            isthing=res.isthing, areas=res.areas,
            instance_idx=res.instance_idx.to(torch.int16),
        )
        return payload, st

    @torch.inference_mode()
    def step(img, prev_obj_feats, track_state, is_first):
        out = model.test_step(img, prev_obj_feats, is_first)
        pred = vps_decode(out["rpn_out"], out["stage_outs"], out["track_obj_feats"], cfg, None)
        seg = out["rpn_out"].seg_preds[0]
        sem_label = torch.argmax(seg, dim=-1).to(torch.int32)
        pan_hw = tuple(pred.result.panoptic_seg.shape[-2:])
        semantic_thing = resize_nearest(sem_label, pan_hw) < cfg.num_thing_classes
        payload, st = one_stream(pred, out["track_embeds"][0], semantic_thing, track_state,
                                 is_first)
        payload["new_obj_feats"] = out["new_obj_feats"]
        payload["track_state"] = st
        return payload

    return step


@dataclass
class VPSResult:
    panoptic_seg: np.ndarray
    segments_info: list
    semantic_map: np.ndarray
    track_map: np.ndarray


class VPSInferencePipeline:
    """Carries per-video state; call `run_frame` for each frame in order.

    Only `tracker_type="quasi_dense"` (the on-device tracker) is ported.
    `device` defaults to CUDA and must be where `model` lives."""

    def __init__(self, model: VideoKNet, cfg: VideoKNetConfig, out_hw,
                 thing_ids_in_orig=KITTI_STEP_THING_IDS, tracker_type: str = "quasi_dense",
                 device: str | torch.device | None = None):
        if tracker_type != "quasi_dense":
            raise NotImplementedError(
                f"tracker_type={tracker_type!r} is not ported yet (ROADMAP: the "
                "host-tracker slice for 'quasi_dense_host', slice F for the others)")
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type:
            raise ValueError(f"model lives on {model_device}, pipeline asked for {self.device}")
        set_fp32_numerics()
        self.cfg = cfg
        self.out_hw = tuple(out_hw)
        self.step = make_device_tracker_frame_step(model, cfg, out_hw, thing_ids_in_orig)
        n_tot = cfg.num_proposals + cfg.num_stuff_classes
        k = cfg.head.conv_kernel_size ** 2
        self._zero_obj = torch.zeros((1, n_tot, k, cfg.head.in_channels),
                                     dtype=torch.float32, device=model_device)
        self.reset()

    def reset(self):
        self.prev_obj_feats = self._zero_obj
        self.track_state = dt.init_tracker_state(
            self.cfg.tracker, self.cfg.test.max_per_img, self.cfg.track.embed_channels,
            device=self._zero_obj.device)

    def _step(self, img: torch.Tensor, is_first: bool) -> dict:
        """One device step; updates the carried state."""
        out = self.step(img, self.prev_obj_feats, self.track_state, bool(is_first))
        self.track_state = out.pop("track_state")
        self.prev_obj_feats = out.pop("new_obj_feats")
        return out

    def run_frame(self, img, is_first: bool) -> VPSResult:
        """img: [1, H, W, 3] float32 (tensor or numpy), normalized."""
        if is_first:
            self.reset()
        img = torch.as_tensor(img, dtype=torch.float32).to(self._zero_obj.device)
        payload = self._step(img, is_first)
        return self._finish_frame({k: v.cpu().numpy() for k, v in payload.items()})

    def _finish_frame(self, host: dict) -> VPSResult:
        """Host formatting of the device-tracker payload: segments_info, one
        nearest upsample of the id map, then the track/semantic LUT gathers."""
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
