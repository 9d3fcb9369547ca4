"""Plain reference of one serving round: the frame step of `model.py`, the
panoptic decode, the quasi-dense tracker and the host finish.

`serve_round` takes B streams' frames and each stream's carried state (the
previous frame's kernels and the tracker memory) and returns what a user
of the service receives a frame (panoptic ids, semantic and track maps at
the output size) with the state it leaves. The tracker is the quasi-dense
embedding tracker with a fixed-capacity memory, run detection by detection
in score order.
"""

from __future__ import annotations

import numpy as np
import torch

from vkbench.reference.model import resize_nearest, test_step

TRACKER_FIELDS = ("embeds", "labels", "boxes", "ids", "last_frame", "valid", "bd_embeds",
                  "bd_labels", "bd_boxes", "bd_valid", "next_id", "frame")


def empty_tracker(capacity, num_dets, dim):
    f32, i32 = torch.float32, torch.int32
    return dict(embeds=torch.zeros(capacity, dim), labels=torch.zeros(capacity, dtype=i32),
                boxes=torch.zeros(capacity, 5), ids=torch.full((capacity,), -1, dtype=i32),
                last_frame=torch.zeros(capacity, dtype=i32),
                valid=torch.zeros(capacity, dtype=torch.bool),
                bd_embeds=torch.zeros(num_dets, dim, dtype=f32),
                bd_labels=torch.zeros(num_dets, dtype=i32), bd_boxes=torch.zeros(num_dets, 5),
                bd_valid=torch.zeros(num_dets, dtype=torch.bool),
                next_id=torch.zeros((), dtype=i32), frame=torch.zeros((), dtype=i32))


# ------------------------------------------------------------------ decode


def merge(probs, scores, labels, nt, score_thr, overlap_thr):
    """Every pixel to its highest score * prob candidate; a candidate stays
    if it keeps `overlap_thr` of its prob >= 0.5 area. Segment ids count
    the kept candidates in descending score order, from 1."""
    k = probs.shape[0]
    isthing = labels < nt
    winner = torch.argmax(scores[:, None, None] * probs, dim=0)
    area = torch.stack([(winner == i).sum() for i in range(k)]).float()
    orig = (probs >= 0.5).sum(dim=(1, 2)).float()
    keep = (area > 0) & (orig > 0) & (area / torch.clamp(orig, min=1.0) >= overlap_thr)
    keep &= torch.where(isthing, scores >= score_thr, True)
    seg_ids = torch.zeros(k, dtype=torch.int64)
    nxt, kept = 0, keep.tolist()
    for i in torch.argsort(-scores, stable=True).tolist():
        if kept[i]:
            nxt += 1
            seg_ids[i] = nxt
    seg_ids = seg_ids.to(probs.device)
    pan = torch.where(keep, seg_ids, 0)[winner]
    return dict(pan=pan, keep=keep, seg_ids=seg_ids, labels=labels.long(), scores=scores,
                isthing=isthing, areas=area.long())


def decode(cls_logits, masks, seg, cfg):
    """One image: top-k (proposal, class) thing pairs and one row a stuff
    class, merged at mask resolution."""
    n, nt = cfg["num_proposals"], cfg["num_thing_classes"]
    score = torch.sigmoid(cls_logits)
    flat = score[:n, :nt].reshape(-1)
    k = min(cfg["max_per_img"], flat.shape[0])
    top, idx = torch.sort(flat, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    src = torch.div(idx, nt, rounding_mode="floor")
    stuff_scores = torch.diagonal(score[n:, nt:])
    labels = torch.cat([idx % nt, nt + torch.arange(cfg["num_stuff_classes"], device=idx.device)])
    probs = torch.sigmoid(torch.cat([masks[:n][src], masks[n:]]))
    res = merge(probs, torch.cat([top, stuff_scores]), labels, nt, cfg["instance_score_thr"],
                cfg["overlap_thr"])
    res["src"] = src
    return res


def thing_boxes(pan, seg_ids, valid, scores, thing_px, scale):
    """xyxy + score boxes [K, 5] of each candidate's thing pixels, in output
    coordinates; zeros for an empty one."""
    boxes = torch.zeros(len(seg_ids), 5)
    boxes[:, 4] = scores
    sy, sx = scale
    for i in range(len(seg_ids)):
        if not valid[i] or seg_ids[i] <= 0:
            continue
        ys, xs = torch.nonzero((pan == seg_ids[i]) & thing_px, as_tuple=True)
        if len(ys):
            boxes[i, :4] = torch.stack([xs.min() * sx, ys.min() * sy, (xs.max() + 1) * sx,
                                        (ys.max() + 1) * sy]).float()
    return boxes


# ----------------------------------------------------------------- tracker


def box_iou(a, b):
    tl = torch.maximum(a[:, None, :2], b[None, :, :2])
    br = torch.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter, min=1e-6)


def _softmax_over(x, mask, dim):
    x = torch.where(mask, x, -1e9)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True)) * mask
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-12)


def track(st, boxes, labels, embeds, valid, tc):
    """One frame of quasi-dense association. Returns (state, ids aligned to
    the inputs: >= 0 a track id, -1 none, -2 suppressed duplicate, and
    which detections survived duplicate removal)."""
    k = boxes.shape[0]
    if not bool(valid.any()):
        return dict(st, frame=st["frame"] + 1), torch.full((k,), -1, dtype=torch.int64), \
            torch.zeros(k, dtype=torch.bool)
    order = torch.argsort(-torch.where(valid, boxes[:, 4], -torch.inf), stable=True)
    b, lab, emb, dv = boxes[order], labels[order].long(), embeds[order], valid[order]
    score = b[:, 4]
    ious = box_iou(b, b)
    survived = dv.clone()
    for i in range(k):
        low = score[i] < tc["obj_score_thr"]
        thr = tc["nms_backdrop_iou_thr"] if low else tc["nms_class_iou_thr"]
        if dv[i] and bool(((ious[i, :i] > thr) & dv[:i]).any()):
            survived[i] = False
    memo_emb = torch.cat([st["embeds"], st["bd_embeds"]])
    memo_lab = torch.cat([st["labels"], st["bd_labels"]]).long()
    memo_ids = torch.cat([torch.where(st["valid"], st["ids"], -1),
                          torch.full_like(st["bd_labels"], -1)]).long()
    memo_valid = torch.cat([st["valid"], st["bd_valid"]])
    feats = emb @ memo_emb.T
    sim = (_softmax_over(feats, memo_valid[None], 1)
           + _softmax_over(feats, survived[:, None], 0)) / 2
    sim = sim * (lab[:, None] == memo_lab[None])
    sim = torch.where(survived[:, None] & memo_valid[None], sim, 0.0)
    ids = torch.full((k,), -1, dtype=torch.int64)
    for i in range(k):  # greedy in score order; a taken column is closed to later rows
        j = int(torch.argmax(sim[i]))
        conf, tid = float(sim[i, j]), int(memo_ids[j])
        if not (survived[i] and conf > tc["match_score_thr"] and tid > -1):
            continue
        if score[i] > tc["obj_score_thr"]:
            ids[i] = tid
            sim[i + 1:, j] = 0.0
        elif conf > tc["nms_conf_thr"]:
            ids[i] = -2
    nxt = int(st["next_id"])
    new = torch.zeros(k, dtype=torch.bool)
    for i in range(k):
        if ids[i] == -1 and score[i] > tc["init_score_thr"] and survived[i]:
            ids[i], nxt, new[i] = nxt, nxt + 1, True
    frame = int(st["frame"])
    s = {f: st[f].clone() for f in ("embeds", "boxes", "labels", "last_frame", "ids")}
    m = tc["memo_momentum"]
    for i in range(k):  # a known track: EMA of its embedding, its box and label
        if ids[i] < 0 or new[i]:
            continue
        hit = torch.nonzero((st["ids"] == ids[i]) & st["valid"])
        if len(hit):
            j = int(hit[0])
            s["embeds"][j] = (1 - m) * st["embeds"][j] + m * emb[i]
            s["boxes"][j], s["labels"][j], s["last_frame"][j] = b[i], lab[i], frame
    alive = st["valid"] & (frame - s["last_frame"] < tc["memo_tracklet_frames"])
    # the j-th new track takes the j-th free slot: empty first, then oldest
    free = torch.argsort(torch.where(alive, s["last_frame"], -1_000_000) * 2 + 1, stable=True)
    valid_new = alive.clone()
    for r, i in enumerate(torch.nonzero(new)[:, 0].tolist()):
        j = int(free[min(r, len(free) - 1)])
        s["embeds"][j], s["boxes"][j], s["labels"][j] = emb[i], b[i], lab[i]
        s["last_frame"][j], s["ids"][j], valid_new[j] = frame, ids[i], True
    bd = survived & (ids == -1)
    for i in range(k):
        if bd[i] and bool(((ious[i, :i] > tc["nms_backdrop_iou_thr"]) & survived[:i]).any()):
            bd[i] = False
    out = dict(s, valid=valid_new, bd_embeds=torch.where(bd[:, None], emb, 0.0),
               bd_labels=torch.where(bd, lab, 0).to(torch.int32),
               bd_boxes=torch.where(bd[:, None], b, 0.0), bd_valid=bd,
               next_id=torch.tensor(nxt, dtype=torch.int32),
               frame=torch.tensor(frame + 1, dtype=torch.int32))
    ids_in = torch.empty(k, dtype=torch.int64)
    ids_in[order] = ids
    surv_in = torch.empty(k, dtype=torch.bool)
    surv_in[order] = survived
    return out, ids_in, surv_in


# ------------------------------------------------------------------- round


def dataset_label(label, nt, thing_ids):
    """Things-first class -> the dataset's label space."""
    if label < nt:
        return thing_ids[label] if thing_ids is not None else label
    cat = label - nt
    if thing_ids is None:
        return cat + nt
    off = 0
    for t in thing_ids:
        if cat + off >= t:
            off += 1
    return cat + off


def upsample_ids(pan, out_hw):
    """Nearest upsampling of an id map, half-pixel centres (float64)."""
    (h, w), (oh, ow) = pan.shape, out_hw
    ys = np.clip(((np.arange(oh) + 0.5) * (h / oh)).astype(np.int64), 0, h - 1)
    xs = np.clip(((np.arange(ow) + 0.5) * (w / ow)).astype(np.int64), 0, w - 1)
    return pan[torch.from_numpy(ys)][:, torch.from_numpy(xs)]


@torch.no_grad()
def serve_round(img, prev, trackers, is_first, cfg, sd, out_hw):
    """B streams, one frame each. `trackers`: one state dict a stream (CPU
    tensors). Returns (frames, new kernels [B, N+S, 1, C], new trackers);
    a frame is dict(pan, sem, track, segments) of numpy maps at `out_hw`."""
    out = test_step(img, prev, is_first, cfg, sd)
    last = out["outs"][-1]
    nt, kth = cfg["num_thing_classes"], cfg["max_per_img"]
    frames, new_trackers = [], []
    for i in range(img.shape[0]):
        res = decode(last["cls"][i], last["scaled"][i], out["head"]["seg"][i], cfg)
        res = {k: v.cpu() for k, v in res.items()}
        pan = res["pan"]
        sem_small = torch.argmax(out["head"]["seg"][i], dim=-1).cpu()
        thing_px = resize_nearest(sem_small, pan.shape) < nt
        valid = res["keep"][:kth] & res["isthing"][:kth]
        scale = (out_hw[0] / pan.shape[0], out_hw[1] / pan.shape[1])
        boxes = thing_boxes(pan, res["seg_ids"][:kth], valid, res["scores"][:kth], thing_px, scale)
        st = trackers[i]
        if bool(is_first[i]):
            st = empty_tracker(len(st["ids"]), len(st["bd_labels"]), st["embeds"].shape[1])
        det_emb = out["embeds"][i][res["src"]].cpu()
        st, ids, survived = track(st, boxes, res["labels"][:kth], det_emb, valid, cfg["tracker"])
        tid = torch.clamp(ids + 1, min=0) * survived
        seg_track = torch.zeros(len(res["seg_ids"]) + 1, dtype=torch.int64)
        for j in range(kth):
            if tid[j] > 0:
                seg_track[res["seg_ids"][j]] = tid[j]
        seg_sem = torch.zeros(len(res["seg_ids"]) + 1, dtype=torch.int64)
        segments = []
        for j in torch.argsort(-res["scores"], stable=True).tolist():
            if res["keep"][j]:
                lab = int(res["labels"][j])
                seg_sem[res["seg_ids"][j]] = dataset_label(lab, nt, cfg["thing_ids"])
                segments.append((int(res["seg_ids"][j]), lab))
        big = upsample_ids(pan, out_hw)
        frames.append(dict(pan=big.numpy().astype(np.int64),
                           sem=seg_sem[big].numpy(), track=seg_track[big].numpy(),
                           segments=sorted(segments)))
        new_trackers.append(st)
    return frames, out["new_kernels"], new_trackers
