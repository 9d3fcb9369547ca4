"""QuasiDenseEmbedTracker on the device: the association math as tensor ops.

Counterpart of `video_knet_tpu/models/video/device_tracker.py`. The tracklet
memory is a fixed-capacity `TrackerState` of tensors threaded by the caller:

- score sort + IoU duplicate removal as a triangular reduction;
- bisoftmax similarity vs the memo with category gating;
- greedy argmax assignment with column suppression, by prefix-commit rounds
  (a bounded Python loop; real frames resolve in 1-2 rounds);
- new-id allocation by cumsum over the carried `next_id` counter;
- EMA memo update, expiry, slot allocation and the one-frame backdrop buffer.

Sorts are stable (`jnp.argsort` is), argmax takes the first maximum, and the
JAX `.at[idx].set(v, mode="drop")` scatters become `_set_drop`, which masks
out-of-range indices explicitly (torch would raise on them).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from video_knet_tpu_torch.config import TrackerConfig

_NEG = -1e9


class TrackerState(NamedTuple):
    """Device-carried tracklet memory (one stream)."""

    embeds: torch.Tensor  # [M, D] EMA appearance embeddings
    labels: torch.Tensor  # [M] int32
    boxes: torch.Tensor  # [M, 5] xyxy + score
    ids: torch.Tensor  # [M] int32 global tracklet ids
    last_frame: torch.Tensor  # [M] int32
    valid: torch.Tensor  # [M] bool
    bd_embeds: torch.Tensor  # [K, D] last frame's backdrops
    bd_labels: torch.Tensor  # [K] int32
    bd_boxes: torch.Tensor  # [K, 5]
    bd_valid: torch.Tensor  # [K] bool
    next_id: torch.Tensor  # int32 scalar
    frame: torch.Tensor  # int32 scalar


def init_tracker_state(cfg: TrackerConfig, num_dets: int, embed_dim: int,
                       device=None) -> TrackerState:
    m = cfg.memo_capacity
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackerState(
        embeds=torch.zeros((m, embed_dim), **f32),
        labels=torch.zeros((m,), **i32),
        boxes=torch.zeros((m, 5), **f32),
        ids=torch.full((m,), -1, **i32),
        last_frame=torch.zeros((m,), **i32),
        valid=torch.zeros((m,), dtype=torch.bool, device=device),
        bd_embeds=torch.zeros((num_dets, embed_dim), **f32),
        bd_labels=torch.zeros((num_dets,), **i32),
        bd_boxes=torch.zeros((num_dets, 5), **f32),
        bd_valid=torch.zeros((num_dets,), dtype=torch.bool, device=device),
        next_id=torch.zeros((), **i32),
        frame=torch.zeros((), **i32),
    )


def init_tracker_state_like(state: TrackerState) -> TrackerState:
    return TrackerState(*[
        torch.full_like(x, -1) if name == "ids" else torch.zeros_like(x)
        for name, x in zip(TrackerState._fields, state)
    ])


def _select(cond, a: TrackerState, b: TrackerState) -> TrackerState:
    """Field-wise `where(cond, a, b)` for a bool or a 0-d bool tensor."""
    if not torch.is_tensor(cond):
        return a if cond else b
    return TrackerState(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def reset_state(state: TrackerState, is_first) -> TrackerState:
    """Zero the memory where `is_first` (sequence boundary)."""
    return _select(is_first, init_tracker_state_like(state), state)


def thing_detections_from_decode(
    pan: torch.Tensor,  # [h, w] int segment-id map at merge resolution
    seg_ids: torch.Tensor,  # [K] 1-based ids of the thing candidates (0 = dropped)
    valid: torch.Tensor,  # [K] keep & isthing
    scores: torch.Tensor,  # [K]
    semantic_thing: torch.Tensor,  # [h, w] bool stuff-argmax filter
    scale_yx: tuple[float, float],  # out_hw / merge_hw
) -> torch.Tensor:
    """Per-candidate xyxy+score boxes [K, 5] from the panoptic id map (boxes
    in out_hw coordinates; empty segments give zero boxes)."""
    h, w = pan.shape
    ok = valid & (seg_ids > 0)
    member = (pan[:, :, None] == torch.where(ok, seg_ids, -1)) & semantic_thing[:, :, None]
    rowhit = member.any(dim=1)  # [h, K]
    colhit = member.any(dim=0)  # [w, K]
    big = 1e9
    yi = torch.arange(h, dtype=torch.float32, device=pan.device)[:, None]
    xi = torch.arange(w, dtype=torch.float32, device=pan.device)[:, None]
    y0 = torch.where(rowhit, yi, big).amin(dim=0)
    y1 = torch.where(rowhit, yi, -big).amax(dim=0)
    x0 = torch.where(colhit, xi, big).amin(dim=0)
    x1 = torch.where(colhit, xi, -big).amax(dim=0)
    nonempty = rowhit.any(dim=0)
    sy, sx = scale_yx
    box = torch.stack([x0 * sx, y0 * sy, (x1 + 1) * sx, (y1 + 1) * sy], dim=1)
    box = torch.where(nonempty[:, None], box, 0.0)
    return torch.cat([box, scores[:, None]], dim=1)


def dataset_class_table(num_thing_classes: int, num_stuff_classes: int,
                        thing_ids_in_orig: tuple[int, ...] | None) -> np.ndarray:
    """[num_classes] LUT: things-first label -> dataset label space."""
    c = num_thing_classes + num_stuff_classes
    table = np.zeros((c,), np.int32)
    for label in range(c):
        if label < num_thing_classes:
            table[label] = thing_ids_in_orig[label] if thing_ids_in_orig is not None else label
        else:
            cat = label - num_thing_classes
            if thing_ids_in_orig is not None:
                offset = 0
                for tid in thing_ids_in_orig:
                    if cat + offset >= tid:
                        offset += 1
                table[label] = cat + offset
            else:
                table[label] = cat + num_thing_classes
    return table


def boxes_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between [N, 4] and [M, 4] xyxy boxes (zeros for empty boxes)."""
    tl = torch.maximum(a[:, None, :2], b[None, :, :2])
    br = torch.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def _masked_softmax(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    x = torch.where(mask, x, _NEG)
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp(x - m) * mask
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-12)


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """argmax taking the first maximum (bool inputs allowed)."""
    return torch.argmax(x.to(torch.int32) if x.dtype == torch.bool else x, dim=dim)


def _greedy_assign(sim: torch.Tensor, memo_ids: torch.Tensor, survived: torch.Tensor,
                   dscore: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """Sequential-greedy assignment by prefix-commit rounds. Returns ids [K]
    in sorted order: tracklet id, -1 unmatched, -2 suppressed.

    A round commits the active detections up to (not including) the first
    one whose argmax column an earlier active assigning detection claims;
    the first active row always commits, so K rounds bound the loop."""
    k, m = sim.shape
    active = torch.ones(k, dtype=torch.bool, device=sim.device)
    ids = torch.full((k,), -1, dtype=torch.int32, device=sim.device)
    cols = torch.arange(m, device=sim.device)
    for _ in range(k):
        if not bool(active.any()):
            break
        memo_ind = _first_argmax(sim, dim=1)
        conf = sim.gather(1, memo_ind[:, None])[:, 0]
        tid = memo_ids[memo_ind]
        matchable = survived & (conf > cfg.match_score_thr) & (tid > -1)
        assign = matchable & (dscore > cfg.obj_score_thr)
        suppressed = matchable & ~assign & (conf > cfg.nms_conf_thr)
        out_id = torch.where(assign, tid, torch.where(suppressed, -2, -1)).to(torch.int32)
        claims = (memo_ind[:, None] == cols[None, :]).float() * (active & assign)[:, None]
        ahead = torch.cumsum(claims, dim=0) - claims  # exclusive prefix sum
        conflict = ahead.gather(1, memo_ind[:, None])[:, 0] > 0.5
        blocked = torch.cumsum((conflict & active).int(), dim=0) > 0
        commit = active & ~blocked
        ids = torch.where(commit, out_id, ids)
        still = active & ~commit
        claimed_cols = (claims * commit[:, None]).sum(dim=0) > 0.5
        sim = torch.where(still[:, None] & claimed_cols[None, :], 0.0, sim)
        active = still
    return ids


def _set_drop(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """`x.at[idx].set(vals, mode="drop")`: rows whose index is out of range
    are dropped. They are routed to one spare row that is cut off after."""
    n = x.shape[0]
    idx = torch.where((idx >= 0) & (idx < n), idx, n).long()
    buf = torch.cat([x, x[:1]])
    buf[idx] = vals if torch.is_tensor(vals) else torch.full_like(buf[idx], vals)
    return buf[:n]


def tracker_match(state: TrackerState, boxes5: torch.Tensor, labels: torch.Tensor,
                  embeds: torch.Tensor, det_valid: torch.Tensor, cfg: TrackerConfig):
    """One frame of association. Returns (new_state, ids, survived), aligned
    to the input detection order: ids >= 0 global tracklet id, -1 unassigned /
    removed / invalid, -2 low-score duplicate of a matched tracklet."""
    k = boxes5.shape[0]
    dev = boxes5.device
    i32 = torch.int32
    det_scores = torch.where(det_valid, boxes5[:, 4], -torch.inf)
    order = torch.argsort(-det_scores, stable=True)  # invalid rows last
    b = boxes5[order]
    lab = labels[order]
    emb = embeds[order]
    dvalid = det_valid[order]
    dscore = b[:, 4]

    # duplicate removal: dropped when an earlier (higher-score) detection
    # overlaps above its threshold
    ious = boxes_iou(b, b)
    thr = torch.where(dscore < cfg.obj_score_thr, cfg.nms_backdrop_iou_thr,
                      cfg.nms_class_iou_thr)
    ar = torch.arange(k, device=dev)
    earlier = ar[None, :] < ar[:, None]  # j < i
    dup = ((ious > thr[:, None]) & earlier & dvalid[None, :]).any(dim=1)
    survived = dvalid & ~dup

    # similarity vs memo (tracklets ++ backdrops), bisoftmax + gating
    memo_embeds = torch.cat([state.embeds, state.bd_embeds])
    memo_labels = torch.cat([state.labels, state.bd_labels])
    memo_ids = torch.cat([torch.where(state.valid, state.ids, -1),
                          torch.full_like(state.bd_labels, -1)])
    memo_valid = torch.cat([state.valid, state.bd_valid])

    feats = emb @ memo_embeds.T
    pair_valid = survived[:, None] & memo_valid[None, :]
    if cfg.match_metric == "bisoftmax":
        d2t = _masked_softmax(feats, memo_valid[None, :], dim=1)
        t2d = _masked_softmax(feats, survived[:, None], dim=0)
        sim = (d2t + t2d) / 2.0
    elif cfg.match_metric == "softmax":
        sim = _masked_softmax(feats, memo_valid[None, :], dim=1)
    else:  # cosine
        en = emb / torch.clamp(emb.norm(dim=1, keepdim=True), min=1e-12)
        mn = memo_embeds / torch.clamp(memo_embeds.norm(dim=1, keepdim=True), min=1e-12)
        sim = en @ mn.T
    if cfg.with_cats:
        sim = sim * (lab[:, None] == memo_labels[None, :])
    sim = torch.where(pair_valid, sim, 0.0)

    ids_sorted = _greedy_assign(sim, memo_ids, survived, dscore, cfg)

    # new-id allocation
    new = (ids_sorted == -1) & (dscore > cfg.init_score_thr) & survived
    new_rank = torch.cumsum(new.to(i32), dim=0, dtype=i32) - 1
    ids_sorted = torch.where(new, state.next_id + new_rank, ids_sorted).to(i32)
    next_id = state.next_id + new.sum(dtype=i32)

    # memo update: EMA of existing tracklets, matched to their slot by id
    frame = state.frame
    m_slots = state.embeds.shape[0]
    has_id = ids_sorted >= 0
    slot_of_det = _first_argmax(
        (state.ids[None, :] == ids_sorted[:, None]) & state.valid[None, :], dim=1)
    found = (state.ids[slot_of_det] == ids_sorted) & state.valid[slot_of_det]
    is_update = has_id & found
    mom = cfg.memo_momentum
    tgt = torch.where(is_update, slot_of_det, m_slots)  # out of range = drop
    embeds_new = _set_drop(state.embeds, tgt, (1 - mom) * state.embeds[slot_of_det] + mom * emb)
    boxes_new = _set_drop(state.boxes, tgt, b)
    labels_new = _set_drop(state.labels, tgt, lab)
    last_new = _set_drop(state.last_frame, tgt, frame.expand(k))

    # expiry before insertion (expiry only reads last_frame)
    alive = state.valid & (frame - last_new < cfg.memo_tracklet_frames)

    # j-th new det -> j-th free slot (invalid first, then oldest last_frame)
    is_insert = new
    slot_key = torch.where(alive, last_new, -1_000_000) * 2 + 1
    free_order = torch.argsort(slot_key, stable=True)
    ins_rank = torch.cumsum(is_insert.to(i32), dim=0, dtype=i32) - 1
    ins_slot = free_order[torch.clamp(ins_rank, 0, m_slots - 1).long()]
    tgt_ins = torch.where(is_insert, ins_slot, m_slots)
    embeds_new = _set_drop(embeds_new, tgt_ins, emb)
    boxes_new = _set_drop(boxes_new, tgt_ins, b)
    labels_new = _set_drop(labels_new, tgt_ins, lab)
    last_new = _set_drop(last_new, tgt_ins, frame.expand(k))
    ids_new = _set_drop(state.ids, tgt_ins, ids_sorted)
    valid_new = _set_drop(alive, tgt_ins, True)

    # backdrops: unmatched dets not overlapping an earlier surviving det
    bd_cand = survived & (ids_sorted == -1)
    bd_dup = ((ious > cfg.nms_backdrop_iou_thr) & earlier & survived[None, :]).any(dim=1)
    bd_keep = bd_cand & ~bd_dup

    new_state = TrackerState(
        embeds=embeds_new,
        labels=labels_new,
        boxes=boxes_new,
        ids=ids_new,
        last_frame=last_new,
        valid=valid_new,
        bd_embeds=torch.where(bd_keep[:, None], emb, 0.0),
        bd_labels=torch.where(bd_keep, lab, 0).to(i32),
        bd_boxes=torch.where(bd_keep[:, None], b, 0.0),
        bd_valid=bd_keep,
        next_id=next_id,
        frame=frame + 1,
    )
    # a frame with no detections leaves the memory untouched (the reference
    # never calls the tracker then); only the frame counter advances
    new_state = _select(det_valid.any(), new_state, state._replace(frame=frame + 1))
    ids_input = torch.zeros(k, dtype=i32, device=dev)
    ids_input[order] = ids_sorted
    survived_input = torch.zeros(k, dtype=torch.bool, device=dev)
    survived_input[order] = survived
    return new_state, ids_input, survived_input
