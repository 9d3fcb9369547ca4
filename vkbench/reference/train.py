"""Plain reference of the VPS train step: the losses of the joint key + ref
forward with their Hungarian assignments, the gradients, the per-group
clip and AdamW.

Ground truth sits in fixed slots (`gt` dicts of masks [B, G, h, w], labels,
valid, ids, stuff masks [B, S, h, w], stuff valid) at the mask-assign
stride. Assignments are solved by scipy's `linear_sum_assignment` on each
problem's valid columns.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from vkbench.reference.model import forward_train, resize_bilinear, upscale

NEG = torch.finfo(torch.float32).min


# ------------------------------------------------------------------ losses


def bce_logits(x, t):
    return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def dice_loss(pred, tgt, w, weight, avg):
    p = torch.sigmoid(pred).flatten(1)
    t = tgt.flatten(1)
    d = 2 * (p * t).sum(1) / (((p * p).sum(1) + 1e-3) + ((t * t).sum(1) + 1e-3))
    return weight * ((1 - d) * w).sum() / max_eps(avg)


def max_eps(x):
    return torch.clamp(x, min=1e-12) if torch.is_tensor(x) else max(float(x), 1e-12)


def focal_loss(logits, labels, label_weights, c, weight, avg, gamma=2.0, alpha=0.25):
    one_hot = (labels[:, None] == torch.arange(c, device=labels.device)).float()
    p = torch.sigmoid(logits)
    pt = (1 - p) * one_hot + p * (1 - one_hot)
    fw = (alpha * one_hot + (1 - alpha) * (1 - one_hot)) * pt ** gamma
    loss = bce_logits(logits, one_hot) * fw
    if label_weights is not None:
        loss = loss * label_weights
    return weight * loss.sum() / max_eps(avg)


def softmax_ce(logits, labels, ignore, weight, avg):
    valid = (labels != ignore).float()
    safe = torch.where(labels == ignore, 0, labels).long()
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, safe[..., None])[..., 0]
    return weight * (nll * valid).sum() / max_eps(avg)


def multi_pos_ce(sim, targets, w, weight):
    pos, neg = targets == 1, targets == 0
    lse_pos = torch.logsumexp(torch.where(pos, -sim, NEG), dim=1)
    lse_neg = torch.logsumexp(torch.where(neg, sim, NEG), dim=1)
    pair = torch.where(pos.any(1) & neg.any(1), lse_pos + lse_neg, NEG)
    loss = torch.logaddexp(torch.zeros_like(pair), pair)
    return weight * (loss * w).sum() / max_eps(w.sum())


def l2_aux(sim, targets, neg_pos_ub=3, neg_margin=0.1, weight=1.0):
    pos, neg = targets == 1, targets == 0
    pred = torch.clamp(torch.where(neg, sim - neg_margin, sim), 0.0, 1.0)
    err = ((pred - pos.float()) ** 2).reshape(-1)
    n_pos, n_neg = int(pos.sum()), int(neg.sum())
    w = pos.reshape(-1).float() + neg.reshape(-1).float()
    if neg_pos_ub > 0 and n_neg / (n_pos + 1) > neg_pos_ub:
        # only the num_pos * neg_pos_ub hardest negatives
        neg_err = torch.where(neg.reshape(-1), err, -1.0)
        order = torch.argsort(-neg_err, stable=True)
        keep = torch.zeros_like(w)
        keep[order[:n_pos * neg_pos_ub]] = 1.0
        w = pos.reshape(-1).float() + neg.reshape(-1).float() * keep
    return weight * (err * w).sum() / max_eps(w.sum())


# ------------------------------------------------------------------- costs


def match_cost(masks, gt_masks, cls=None, labels=None, cls_weight=2.0, dice_w=4.0, mask_w=1.0):
    """[B, N, h, w] logits against [B, G, h, w] GT -> [B, N, G]."""
    hw = masks.shape[-1] * masks.shape[-2]
    p = torch.clamp(torch.sigmoid(masks), 0.001, 1.0).flatten(2)
    t = gt_masks.flatten(2)
    d = 2 * (p @ t.transpose(1, 2)) / (((p * p).sum(-1) + 1e-3)[..., None]
                                       + ((t * t).sum(-1) + 1e-3)[:, None])
    cost = -dice_w * d
    p = torch.clamp(torch.sigmoid(masks), 0.01, 1.0).flatten(2)
    pos = p @ t.transpose(1, 2)
    neg = hw - p.sum(-1)[..., None] - t.sum(-1)[:, None] + pos
    cost = cost - mask_w * (pos + neg) / hw
    if cls is not None and cls_weight:
        s = torch.sigmoid(cls)
        diff = (-torch.log(s + 1e-12) * 0.25 * (1 - s) ** 2
                + torch.log(1 - s + 1e-12) * 0.75 * s ** 2)
        idx = torch.clamp(labels, min=0).long()[:, None, :].expand(-1, diff.shape[1], -1)
        cost = cost + cls_weight * torch.gather(diff, 2, idx)
    return cost


def solve(cost, valid):
    """Minimum-cost matching of each image's valid GT slots to distinct
    predictions. Returns (gt_of_pred [B, N], pred_of_gt [B, G]), -1 unmatched."""
    b, n, g = cost.shape
    g2p = torch.full((b, n), -1, dtype=torch.int64)
    p2g = torch.full((b, g), -1, dtype=torch.int64)
    c = cost.detach().double().cpu().numpy()
    v = valid.cpu().numpy()
    for i in range(b):
        cols = np.nonzero(v[i])[0]
        if len(cols) == 0:
            continue
        rows, sel = linear_sum_assignment(c[i][:, cols])
        g2p[i, torch.from_numpy(rows)] = torch.from_numpy(cols[sel])
        p2g[i, torch.from_numpy(cols[sel])] = torch.from_numpy(rows)
    return g2p.to(cost.device), p2g.to(cost.device)


def gather_rows(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def owner_map(occupied, prio, value, empty):
    """Per pixel, value[b, r] of the occupied row r of highest priority."""
    sel = torch.argmax(occupied.to(prio.dtype) * prio[..., None, None], dim=1)
    at = torch.gather(value, 1, sel.flatten(1)).reshape(sel.shape)
    return torch.where(occupied.any(1), at, empty)


def rank_target(rows_t, rows_w, orig_idx):
    occupied = (rows_t > 0) & (rows_w[..., None, None] > 0)
    prio = torch.where(rows_w > 0, orig_idx.long() + 1, 0)
    return owner_map(occupied, prio, orig_idx.long(), 255)


def semantic_target(gt, nt, c):
    s = gt["sem_masks"].shape[1]
    dev = gt["masks"].device
    masks = torch.cat([gt["sem_masks"] * gt["sem_valid"][..., None, None],
                       gt["masks"] * gt["valid"][..., None, None]], dim=1)
    labels = torch.cat([(nt + torch.arange(s, device=dev))[None].expand(gt["sem_valid"].shape),
                        gt["labels"].long()], dim=1)
    prio = torch.arange(1, masks.shape[1] + 1, device=dev).expand(masks.shape[0], -1)
    return owner_map(masks > 0, prio, labels, c)


def pred_of_gt(g2p, g):
    eq = g2p[:, :, None] == torch.arange(g, device=g2p.device)
    return torch.where(eq.any(1), torch.argmax(eq.int(), dim=1), -1)


def mask_losses(pred, tgt, w, mask_w, dice_w, names):
    b, r = w.shape
    pred, tgt, w = pred.flatten(0, 1), tgt.flatten(0, 1), w.flatten()
    rows = w.sum()
    bce = (bce_logits(pred, tgt) * w[:, None, None]).sum() / max_eps(rows * pred[0].numel())
    return {names[0]: mask_w * bce, names[1]: dice_loss(pred, tgt, w, dice_w, rows)}


def rpn_losses(head, gt, g2p, cfg):
    r = cfg["rpn"]
    c = cfg["num_thing_classes"] + cfg["num_stuff_classes"]
    scaled = upscale(head["thing_masks"], r["feat_downsample_stride"])
    p2g = pred_of_gt(g2p, gt["masks"].shape[1])
    w = (p2g >= 0).float()
    safe = torch.clamp(p2g, min=0)
    out = mask_losses(gather_rows(scaled, safe), gt["masks"], w, r["loss_mask_weight"],
                      r["loss_dice_weight"], ("loss_rpn_mask", "loss_rpn_dice"))
    if r["loss_rank_weight"] > 0:
        rt = rank_target(gt["masks"], w, safe)
        out["loss_rpn_rank"] = softmax_ce(scaled.movedim(1, -1), rt, 255, r["loss_rank_weight"],
                                          (rt != 255).float().sum())
    st = semantic_target(gt, cfg["num_thing_classes"], c)
    h, wd = head["seg"].shape[1:3]
    f = r["feat_downsample_stride"]
    seg = resize_bilinear(head["seg"], (h * f, wd * f))
    out["loss_rpn_seg"] = softmax_ce(seg, st, c, r["loss_seg_weight"], (st != c).float().sum())
    return out


def stage_losses(o, g2p, gt, cfg, prefix):
    h = cfg["head"]
    nt, s = cfg["num_thing_classes"], cfg["num_stuff_classes"]
    c = nt + s
    b, n = g2p.shape
    dev = g2p.device
    thing = torch.where(g2p >= 0, gather_rows(gt["labels"], torch.clamp(g2p, min=0)).long(), c)
    stuff = torch.where(gt["sem_valid"], (nt + torch.arange(s, device=dev))[None], c)
    labels = torch.cat([thing, stuff], dim=1)
    thing_w = torch.cat([torch.ones(b, n, nt, device=dev), torch.zeros(b, n, s, device=dev)], -1)
    stuff_w = torch.cat([torch.zeros(s, nt, device=dev), torch.eye(s, device=dev)], -1)
    lw = torch.cat([thing_w, stuff_w[None].expand(b, s, c)], dim=1)
    num_pos = (labels < c).float().sum()
    out = {f"{prefix}_loss_cls": focal_loss(o["cls"].flatten(0, 1), labels.flatten(),
                                            lw.flatten(0, 1), c, h["loss_cls_weight"],
                                            torch.clamp(num_pos, min=1.0), h["focal_gamma"],
                                            h["focal_alpha"])}
    p2g = pred_of_gt(g2p, gt["masks"].shape[1])
    safe = torch.clamp(p2g, min=0)
    rows = torch.cat([gather_rows(o["masks"][:, :n], safe), o["masks"][:, n:]], dim=1)
    rows = upscale(rows, h["mask_upsample_stride"])
    tgt = torch.cat([gt["masks"], gt["sem_masks"]], dim=1)
    w = torch.cat([(p2g >= 0).float(), gt["sem_valid"].float()], dim=1)
    out.update(mask_losses(rows, tgt, w, h["loss_mask_weight"], h["loss_dice_weight"],
                           (f"{prefix}_loss_mask", f"{prefix}_loss_dice")))
    if h["loss_rank_weight"] > 0:
        orig = torch.cat([safe, (n + torch.arange(s, device=dev))[None].expand(b, s)], dim=1)
        rt = rank_target(tgt, w, orig)
        out[f"{prefix}_loss_rank"] = softmax_ce(o["scaled"].movedim(1, -1), rt, 255,
                                                h["loss_rank_weight"], (rt != 255).float().sum())
    return out


def branch_costs(head, outs, gt, cfg):
    n, nt = cfg["num_proposals"], cfg["num_thing_classes"]
    w = dict(cls_weight=cfg["assigner_cls_weight"], dice_w=cfg["assigner_dice_weight"],
             mask_w=cfg["assigner_mask_weight"])
    costs = [match_cost(upscale(head["thing_masks"], cfg["rpn"]["feat_downsample_stride"]).detach(),
                        gt["masks"], **w)]
    prev = upscale(head["masks"], cfg["head"]["mask_upsample_stride"])[:, :n]
    prev_cls = None
    for s in range(cfg["num_stages"]):
        cls = None if prev_cls is None else prev_cls[:, :n, :nt].detach()
        costs.append(match_cost(prev.detach(), gt["masks"], cls, gt["labels"], **w))
        prev, prev_cls = outs[s]["scaled"][:, :n], outs[s]["cls"]
    costs.append(match_cost(prev.detach(), gt["masks"], prev_cls[:, :n, :nt].detach(),
                            gt["labels"], **w))
    return costs


def track_losses(key_emb, ref_emb, key_p2g, ref_p2g, gt, ref_gt, t):
    kg = gather_rows(key_emb, torch.clamp(key_p2g, min=0))
    rg = gather_rows(ref_emb, torch.clamp(ref_p2g, min=0))
    kv, rv = (key_p2g >= 0) & gt["valid"], (ref_p2g >= 0) & ref_gt["valid"]
    lt, la = [], []
    for i in range(key_emb.shape[0]):
        pair = kv[i][:, None] & rv[i][None]
        same = (gt["ids"][i][:, None] == ref_gt["ids"][i][None]) & pair
        targets = torch.where(pair, same.long(), -1)
        w = (same.sum(1) > 0).float()
        loss = multi_pos_ce(kg[i] @ rg[i].T, targets, w, t["loss_track_weight"])
        lt.append(loss if w.sum() > 0 else loss * 0)
        kn = kg[i] / torch.clamp(kg[i].norm(dim=-1, keepdim=True), min=1e-12)
        rn = rg[i] / torch.clamp(rg[i].norm(dim=-1, keepdim=True), min=1e-12)
        aux = l2_aux(kn @ rn.T, targets, t["aux_neg_pos_ub"], t["aux_neg_margin"],
                     t["loss_track_aux_weight"])
        la.append(aux if pair.any() else aux * 0)
    return {"loss_track": torch.stack(lt).mean(), "loss_track_aux": torch.stack(la).mean()}


def vps_losses(out, gt, ref_gt, cfg):
    """Every loss of the joint step; also the number of GT slots the key
    frame's final stage matched."""
    key_c = branch_costs(out["key_head"], out["key_outs"], gt, cfg)
    ref_c = branch_costs(out["ref_head"], out["ref_outs"], ref_gt, cfg)
    key_sol = [solve(c, gt["valid"]) for c in key_c]
    ref_sol = [solve(c, ref_gt["valid"]) for c in ref_c]
    losses = rpn_losses(out["key_head"], gt, key_sol[0][0], cfg)
    for s in range(cfg["num_stages"]):
        losses.update(stage_losses(out["key_outs"][s], key_sol[s + 1][0], gt, cfg, f"s{s}"))
    losses.update({k + "_ref_rpn": v for k, v in
                   rpn_losses(out["ref_head"], ref_gt, ref_sol[0][0], cfg).items()})
    for s in range(cfg["num_stages"]):
        losses.update({k + "_ref": v for k, v in stage_losses(
            out["ref_outs"][s], ref_sol[s + 1][0], ref_gt, cfg, f"s{s}").items()})
    losses.update(track_losses(out["key_embeds"], out["ref_embeds"], key_sol[-1][1],
                               ref_sol[-1][1], gt, ref_gt, cfg["track"]))
    return losses, int((key_sol[-1][1] >= 0).sum())


# ------------------------------------------------------------------- steps


def lr_at(step, o):
    warm = o["warmup_ratio"] + (1 - o["warmup_ratio"]) * step / o["warmup_iters"]
    return o["base_lr"] * (warm if step < o["warmup_iters"] else 1.0)


def trainable(name, cfg):
    """Every parameter but ResNet's frozen stem and stages; buffers never."""
    if name.endswith(("running_mean", "running_var")):
        return False
    if cfg["backbone"] == "resnet50" and cfg["frozen_stages"] >= 0:
        frozen = ("backbone.conv1.", "backbone.bn1.") + tuple(
            f"backbone.layer{s}_" for s in range(1, cfg["frozen_stages"] + 1))
        return not name.startswith(frozen)
    return True


def one_step(params, fixed, m, v2, step, batch, gen, cfg):
    """One AdamW step, in place, at 0-based index `step` (the LR and the
    bias corrections follow it). Returns (the loss, the clipped gradient a
    leaf, the key frame's matched GT slots)."""
    o = cfg["optim"]
    names = list(params)
    img, ref_img, gt, ref_gt = batch
    out = forward_train(img, ref_img, cfg, {**fixed, **params}, gen)
    parts, hit = vps_losses(out, gt, ref_gt, cfg)
    total = sum(parts.values())
    grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
    for group in ("backbone", "rest"):
        keys = [k for k in names if k.startswith("backbone.") == (group == "backbone")]
        norm = torch.sqrt(sum((grads[k].double() ** 2).sum() for k in keys))
        if norm >= o["grad_clip"]:
            for k in keys:
                grads[k] = grads[k] * (o["grad_clip"] / norm).float()
    lr0 = lr_at(step, o)
    with torch.no_grad():
        for k in names:
            lr = lr0 * (o["backbone_lr_mult"] if k.startswith("backbone.") else 1.0)
            p, g = params[k], grads[k]
            p.mul_(1 - lr * o["weight_decay"])
            m[k].mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
            v2[k].mul_(o["beta2"]).addcmul_(g, g, value=1 - o["beta2"])
            bc1 = 1 - o["beta1"] ** (step + 1)
            bc2 = math.sqrt(1 - o["beta2"] ** (step + 1))
            p.addcdiv_(m[k], v2[k].sqrt() / bc2 + o["eps"], value=-lr / bc1)
    return float(total.detach()), {k: g.detach() for k, g in grads.items()}, hit


def _split(sd, cfg):
    names = [k for k in sd if trainable(k, cfg)]
    params = {k: sd[k].detach().clone().requires_grad_() for k in names}
    return params, {k: v for k, v in sd.items() if k not in params}


def train_steps(sd, cfg, batches, generators):
    """Runs len(batches) AdamW steps from `sd`. Returns (losses a step, the
    first step's clipped gradient a leaf, the parameters at the end, the
    key frame's matched GT slots a step)."""
    params, fixed = _split(sd, cfg)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad, matched = [], None, []
    for step, (batch, gen) in enumerate(zip(batches, generators)):
        loss, grads, hit = one_step(params, fixed, m, v2, step, batch, gen, cfg)
        if first_grad is None:
            first_grad = grads
        losses.append(loss)
        matched.append(hit)
    return losses, first_grad, {k: p.detach() for k, p in params.items()}, matched


def train_step_from(sd, moments, step, cfg, batch, gen):
    """One AdamW step at index `step` from the weights `sd` and the
    optimizer's moments ({leaf: (first, second)}; zeros for a leaf that has
    none). Returns (the loss, the clipped gradient a leaf, the parameters
    after it, the key frame's matched GT slots)."""
    params, fixed = _split(sd, cfg)
    m, v2 = {}, {}
    for k, p in params.items():
        first, second = moments.get(k, (None, None))
        m[k] = torch.zeros_like(p) if first is None else first.detach().clone()
        v2[k] = torch.zeros_like(p) if second is None else second.detach().clone()
    loss, grads, hit = one_step(params, fixed, m, v2, step, batch, gen, cfg)
    return loss, grads, {k: p.detach() for k, p in params.items()}, hit
