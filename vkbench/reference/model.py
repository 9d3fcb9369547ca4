"""Plain PyTorch Video K-Net: the forward passes the benchmark holds the
port against, written as functions of a state dict.

Every layer reads its weights from `sd` by the names the benchmark makes
them under (`vkbench/common.py:make_weights`), so the same tensors feed the program and
this file. The equations follow the published model as the port serves and
trains it: NHWC maps, XLA's "SAME" padding, flax's norms (one-pass
LayerNorm in Swin, two-pass GroupNorm, torch LayerNorm in the heads),
bilinear resizes that antialias when they shrink, the half-pixel nearest
resize. Mask pooling and mask assembly are plain einsums here. Nothing in
this package imports the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ layers


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, sd, p, stride=1, padding="SAME", bias=True):
    """NHWC convolution with the OIHW weight `p.weight`."""
    w = sd[p + ".weight"]
    b = sd.get(p + ".bias") if bias else None
    k = w.shape[-1]
    y = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, bo), (le, r) = same_pad(y.shape[-2], k, stride), same_pad(y.shape[-1], k, stride)
        y = F.pad(y, (le, r, t, bo))
        padding = 0
    return F.conv2d(y, w, b, stride=stride, padding=padding).permute(0, 2, 3, 1)


def linear(x, sd, p, bias=True):
    return F.linear(x, sd[p + ".weight"], sd[p + ".bias"] if bias else None)


def layer_norm(x, sd, p, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], eps)


def fast_layer_norm(x, sd, p, eps=1e-5):
    """flax's default LayerNorm: var = E[x^2] - E[x]^2."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * sd[p + ".weight"]) + sd[p + ".bias"]


def group_norm(x, sd, p, groups=32, eps=1e-5):
    b, c = x.shape[0], x.shape[-1]
    g = x.reshape(b, -1, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * sd[p + ".weight"] + sd[p + ".bias"]


def batch_norm(x, sd, p, eps=1e-5):
    """Inference BatchNorm on the running averages."""
    scale = sd[p + ".weight"] * torch.rsqrt(sd[p + ".running_var"] + eps)
    return (x - sd[p + ".running_mean"]) * scale + sd[p + ".bias"]


def conv_gn_relu(x, sd, p, stride=1):
    return F.relu(group_norm(conv(x, sd, p + ".Conv_0", stride, bias=False), sd,
                             p + ".GroupNorm_0"))


def mlp(x, sd, p, n):
    for i in range(n):
        x = F.relu(layer_norm(linear(x, sd, f"{p}.Dense_{i}", bias=False), sd,
                              f"{p}.LayerNorm_{i}"))
    return x


def ffn(x, sd, p):
    return x + linear(F.relu(linear(x, sd, p + ".Dense_0")), sd, p + ".Dense_1")


def attention(q_in, kv_in, sd, p, heads):
    b, n, d = q_in.shape
    hd = d // heads
    q = linear(q_in, sd, p + ".query").view(b, n, heads, hd).transpose(1, 2) / math.sqrt(hd)
    k = linear(kv_in, sd, p + ".key").view(b, -1, heads, hd).transpose(1, 2)
    v = linear(kv_in, sd, p + ".value").view(b, -1, heads, hd).transpose(1, 2)
    y = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
    return linear(y.transpose(1, 2).reshape(b, n, d), sd, p + ".out")


def sine_encoding(h, w, num_feats, device):
    """DETR's normalised 2-D sine code, [H, W, 2 * num_feats]."""
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim = 10000 ** (2 * torch.div(dim, 2, rounding_mode="floor") / num_feats)

    def code(v):
        v = v[:, :, None] / dim
        return torch.stack([v[:, :, 0::2].sin(), v[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)

    return torch.cat([code(y), code(x)], dim=-1)


def nearest_index(m, n, device):
    """Source index floor((i + 0.5) * m / n) in float32."""
    return ((torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n).floor().long()


def resize_nearest(x, hw, dims=(-2, -1)):
    for d, n in zip(dims, hw):
        if x.shape[d] != n:
            x = x.index_select(d, nearest_index(x.shape[d], n, x.device))
    return x


def resize_bilinear(x, hw):
    """NHWC bilinear resize, half-pixel centres, antialiased when it shrinks."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    shrink = hw[0] < x.shape[1] or hw[1] < x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


def resize_masks(m, hw):
    """[B, N, h, w] mask logits resized bilinearly to `hw`."""
    if tuple(m.shape[-2:]) == tuple(hw):
        return m
    shrink = hw[0] < m.shape[-2] or hw[1] < m.shape[-1]
    return F.interpolate(m, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=shrink)


def mask_pool(mask_logits, feats, thr=0.5):
    """K1: sum of the features under each binarised mask. [B,N,H,W], [B,H,W,C]."""
    hard = (torch.sigmoid(mask_logits) > thr).to(feats.dtype)
    return torch.einsum("bnhw,bhwc->bnc", hard, feats)


def assemble(kernels, feats):
    """K2: each kernel's dot product with every pixel. [B,N,C], [B,H,W,C]."""
    return torch.einsum("bnc,bhwc->bnhw", kernels, feats)


# --------------------------------------------------------------- backbones


def resnet50(x, sd, frozen_stages=1):
    p = "backbone"
    y = F.relu(batch_norm(conv(x, sd, p + ".conv1", 2, padding=3, bias=False), sd, p + ".bn1"))
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    if frozen_stages >= 0:
        y = y.detach()
    outs = []
    for s, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            q = f"{p}.layer{s}_block{b}"
            stride = 2 if b == 0 and s > 1 else 1
            z = F.relu(batch_norm(conv(y, sd, q + ".conv1", bias=False), sd, q + ".bn1"))
            z = F.relu(batch_norm(conv(z, sd, q + ".conv2", stride, bias=False), sd, q + ".bn2"))
            z = batch_norm(conv(z, sd, q + ".conv3", bias=False), sd, q + ".bn3")
            if q + ".downsample_conv.weight" in sd:
                y = batch_norm(conv(y, sd, q + ".downsample_conv", stride, bias=False), sd,
                               q + ".downsample_bn")
            y = F.relu(z + y)
        if frozen_stages >= s:
            y = y.detach()
        outs.append(y)
    return outs


def fpn(feats, sd):
    lat = [conv(f, sd, f"neck.lateral{i}") for i, f in enumerate(feats)]
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + resize_nearest(lat[i], lat[i - 1].shape[1:3], dims=(1, 2))
    return [conv(t, sd, f"neck.fpn_conv{i}") for i, t in enumerate(lat)]


SWIN_BASE = (128, (2, 2, 18, 2), (4, 8, 16, 32))


def _rel_index(ws, device):
    c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    c = c.reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1).to(device)


def _shift_mask(hp, wp, ws, shift, device):
    def band(n):
        i = torch.arange(n, device=device)
        return (i >= n - ws).long() + (i >= n - shift).long()

    region = band(hp)[:, None] * 3 + band(wp)[None, :]
    win = region.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(win[:, None, :] == win[:, :, None], 0.0, -100.0)


def _windows(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _unwindows(t, ws, h, w):
    b = t.shape[0] // ((h // ws) * (w // ws))
    return t.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _drop_path(x, rate, generator):
    """Stochastic depth: one uniform draw a sample from `generator`."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand((x.shape[0],), generator=generator, device=x.device)
    return x * (draw < keep).to(x.dtype).reshape(-1, 1, 1, 1) / keep


def _swin_block(x, sd, p, heads, ws, mask, rate, generator):
    b, h, w, c = x.shape
    y = fast_layer_norm(x, sd, p + ".norm1")
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    hp, wp = h + ph, w + pw
    shift = ws // 2 if mask is not None else 0
    y = F.pad(y, (0, 0, 0, pw, 0, ph))
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    t = _windows(y, ws)
    bw, n, _ = t.shape
    hd = c // heads
    qkv = linear(t, sd, p + ".attn.qkv").reshape(bw, n, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    att = (q * hd ** -0.5) @ k.transpose(-1, -2)
    table = sd[p + ".attn.relative_position_bias_table"]
    att = att + table[_rel_index(ws, x.device)].reshape(n, n, heads).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        att = att.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None]
        att = att.reshape(bw, heads, n, n)
    t = (torch.softmax(att, dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
    y = _unwindows(linear(t, sd, p + ".attn.proj"), ws, hp, wp)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = x + _drop_path(y[:, :h, :w], rate, generator)
    z = fast_layer_norm(x, sd, p + ".norm2")
    z = linear(F.gelu(linear(z, sd, p + ".mlp_fc1")), sd, p + ".mlp_fc2")
    return x + _drop_path(z, rate, generator)


def swin_base(x, sd, frozen_stages=1, drop_path_rate=0.0, generator=None, ws=7):
    dim, depths, heads = SWIN_BASE
    p = "backbone"
    x = fast_layer_norm(conv(x, sd, p + ".patch_embed", 4), sd, p + ".patch_norm")
    if frozen_stages >= 0:
        x = x.detach()
    total = sum(depths)
    rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
    outs, blk = [], 0
    for s, (depth, nh) in enumerate(zip(depths, heads)):
        hp, wp = (-(-n // ws) * ws for n in x.shape[1:3])
        mask = _shift_mask(hp, wp, ws, ws // 2, x.device) if min(hp, wp) > ws else None
        for i in range(depth):
            q = f"{p}.stage{s}_pairs.{i // 2}.blk{i % 2}"
            x = _swin_block(x, sd, q, nh, ws, mask if i % 2 else None, rates[blk + i], generator)
        outs.append(fast_layer_norm(x, sd, f"{p}.out_norm{s}"))
        if s < 3:
            h, w = x.shape[1:3]
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], dim=-1)
            x = linear(fast_layer_norm(x, sd, f"{p}.downsample{s}.norm"), sd,
                       f"{p}.downsample{s}.reduction", bias=False)
        if frozen_stages >= s + 1:
            x = x.detach()
        blk += depth
    return outs


# ------------------------------------------------------------------- heads


def semantic_fpn(feats, sd, p="rpn_head.localization_fpn", end_level=3, upsample_times=2):
    levels = []
    for i in range(end_level + 1):
        x = feats[i]
        if i == end_level:
            h, w, c = x.shape[1:]
            x = x + sine_encoding(h, w, c // 2, x.device)[None]
        if i == 0:
            for j in range(end_level - upsample_times):
                x = conv_gn_relu(x, sd, f"{p}.l0_conv{j}", stride=2)
        else:
            n_up = upsample_times - (end_level - i)
            for j in range(i):
                x = conv_gn_relu(x, sd, f"{p}.l{i}_conv{j}")
                if j < n_up:
                    x = resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]))
        levels.append(x)
    fused = levels[0]
    for m in levels[1:]:
        fused = fused + resize_bilinear(m, fused.shape[1:3])
    return conv_gn_relu(fused, sd, p + ".conv_pred"), conv_gn_relu(fused, sd, p + ".aux_conv0")


def kernel_head(feats, cfg, sd):
    """The init head: (proposal kernels [B, N+S, 1, C], x_feats, mask logits
    [B, N+S, h, w], seg logits [B, h, w, classes], thing mask logits)."""
    p = "rpn_head"
    loc, sem = semantic_fpn(feats, sd)
    loc = conv_gn_relu(loc, sd, p + ".loc_conv0")
    sem = conv_gn_relu(sem, sd, p + ".seg_conv0")
    b = loc.shape[0]
    init = sd[p + ".init_kernels"][None].expand(b, -1, -1)
    masks = assemble(init, loc)
    seg = conv(sem, sd, p + ".conv_seg")
    x_feats = sem + loc
    kernels = init + mask_pool(masks, x_feats)
    nt = cfg["num_thing_classes"]
    thing_masks = masks
    masks = torch.cat([masks, seg[..., nt:].permute(0, 3, 1, 2)], dim=1)
    stuff = sd[p + ".conv_seg.weight"][nt:, :, 0, 0]
    kernels = torch.cat([kernels, stuff[None].expand(b, -1, -1)], dim=1)
    return dict(kernels=kernels[:, :, None, :], x_feats=x_feats, masks=masks, seg=seg,
                thing_masks=thing_masks)


def kernel_updator(update, inp, sd, p):
    f = sd[p + ".input_gate.weight"].shape[0]
    params = linear(update, sd, p + ".dynamic_layer")
    p_in, p_out = params[..., :f], params[..., f:]
    feats = linear(inp, sd, p + ".input_layer")
    i_in, i_out = feats[..., :f], feats[..., f:]
    gate = i_in * p_in[..., None, :]
    input_gate = torch.sigmoid(layer_norm(linear(gate, sd, p + ".input_gate"), sd,
                                          p + ".input_norm_in"))
    update_gate = torch.sigmoid(layer_norm(linear(gate, sd, p + ".update_gate"), sd,
                                           p + ".norm_in"))
    out = (update_gate * layer_norm(p_out, sd, p + ".norm_out")[..., None, :]
           + input_gate * layer_norm(i_out, sd, p + ".input_norm_out"))
    return F.relu(layer_norm(linear(out, sd, p + ".fc_layer"), sd, p + ".fc_norm"))


def _cross_link(cur, prev, sd, p, name, heads):
    b, n, g, c = cur.shape
    cf, pf = cur.reshape(b, n, g * c), prev.reshape(b, n, g * c)
    y = layer_norm(cf + attention(cf, pf, sd, f"{p}.attention_{name}", heads), sd,
                   f"{p}.attention_{name}_norm").reshape(b, n, g, c)
    return layer_norm(ffn(y, sd, f"{p}.link_ffn_{name}"), sd, f"{p}.link_ffn_{name}_norm")


def update_stage(x, kernels, masks, sd, p, heads, prev=None):
    """One kernel update stage (conv kernel size 1, previous_type 'ffn', no
    previous link on the input kernels). Returns (cls logits, mask logits,
    kernels, tracking kernels or None)."""
    b, n = kernels.shape[:2]
    x = conv(x, sd, p + ".feat_transform")
    pooled = mask_pool(resize_masks(masks, x.shape[1:3]), x)
    obj = kernel_updator(pooled, kernels, sd, p + ".kernel_update_conv")
    g, c = obj.shape[2:]
    flat = obj.reshape(b, n, g * c)
    flat = layer_norm(flat + attention(flat, flat, sd, p + ".attention", heads), sd,
                      p + ".attention_norm")
    obj = layer_norm(ffn(flat.reshape(b, n, g, c), sd, p + ".ffn"), sd, p + ".ffn_norm")
    track = None if prev is None else _cross_link(obj, prev, sd, p, "previous", heads)
    cls = linear(mlp(obj.sum(dim=-2), sd, p + ".cls_fcs", 1), sd, p + ".fc_cls")
    mask_kernels = linear(mlp(obj, sd, p + ".mask_fcs", 1), sd, p + ".fc_mask")
    return cls, assemble(mask_kernels[:, :, 0], x), obj, track


def upscale(masks, stride):
    h, w = masks.shape[-2:]
    return resize_masks(masks, (h * stride, w * stride))


def stages(head, cfg, sd, prev=None):
    """The 3 update stages; the last links to `prev` when given."""
    outs, track = [], None
    kernels, masks = head["kernels"], head["masks"]
    n = cfg["num_stages"]
    for s in range(n):
        cls, masks, kernels, t = update_stage(head["x_feats"], kernels, masks, sd,
                                              f"mask_head_{s}", cfg["num_heads"],
                                              prev if s == n - 1 else None)
        outs.append(dict(cls=cls, masks=masks, scaled=upscale(masks, cfg["mask_upsample_stride"]),
                         kernels=kernels))
        if t is not None:
            track = t
    return outs, track


def track_embed(kernels, sd, num_fcs=2):
    p = "track_embed"
    x = kernels[..., 0, :]
    y = linear(F.relu(layer_norm(linear(x, sd, p + ".embed_fc0", bias=False), sd,
                                 p + ".embed_ln0")), sd, p + ".fc_embed")
    for i in range(num_fcs):
        y = F.relu(linear(y, sd, f"{p}.track_fc{i}"))
    return linear(y, sd, p + ".track_fc_embed")


def pyramid(img, cfg, sd, generator=None):
    if cfg["backbone"] == "resnet50":
        feats = resnet50(img, sd, cfg["frozen_stages"])
    else:
        feats = swin_base(img, sd, cfg["frozen_stages"], cfg["drop_path_rate"], generator)
    return fpn(feats, sd)


def test_step(img, prev, is_first, cfg, sd):
    """One online step of B streams. prev [B, N+S, 1, C]; is_first [B] bool."""
    prev = torch.where(is_first[:, None, None, None], torch.zeros_like(prev), prev)
    head = kernel_head(pyramid(img, cfg, sd), cfg, sd)
    outs, track = stages(head, cfg, sd, prev)
    last = outs[-1]
    track_src = torch.where(is_first[:, None, None, None], last["kernels"], track)
    embeds = track_embed(track_src[:, :cfg["num_proposals"]], sd)
    return dict(head=head, outs=outs, track_kernels=track_src, embeds=embeds,
                new_kernels=last["kernels"])


def forward_train(img, ref_img, cfg, sd, generator=None):
    """The joint train forward over [ref; key]: the ref stages plain, the
    key stages linked to the ref branch's final kernels."""
    b = img.shape[0]
    head = kernel_head(pyramid(torch.cat([ref_img, img]), cfg, sd, generator), cfg, sd)
    ref_head = {k: v[:b] for k, v in head.items()}
    key_head = {k: v[b:] for k, v in head.items()}
    ref_outs, _ = stages(ref_head, cfg, sd)
    key_outs, key_track = stages(key_head, cfg, sd, ref_outs[-1]["kernels"])
    n = cfg["num_proposals"]
    return dict(key_head=key_head, ref_head=ref_head, key_outs=key_outs, ref_outs=ref_outs,
                key_embeds=track_embed(key_track[:, :n], sd),
                ref_embeds=track_embed(ref_outs[-1]["kernels"][:, :n], sd))
