"""Reference torch checkpoints onto the port's modules.

Counterpart of `video_knet_tpu/utils/torch_import.py`. Each importer returns
{port state_dict key: tensor} for `module.load_state_dict`; the layouts are
the reference's own (conv OIHW, Linear [out, in]), so a weight is a copy
under a new name, apart from the two rules below.

`import_torch_knet`: a whole mmdet image or Video K-Net state dict onto
`KNet`'s keys (`image_to_video_params` moves them onto `VideoKNet`'s):

  backbone.* / neck.*                 -> utils/checkpoint.import_torch_resnet /
                                         _fpn, or `import_torch_swin` when the
                                         dict has `backbone.patch_embed.*`
  rpn_head.init_kernels.weight [N, C, 1, 1]
                                      -> rpn_head.init_kernels [N, C]
  rpn_head.{loc,seg}_convs.{i}, rpn_head.localization_fpn.{convs_all_levels.
      {i}.conv{j}, conv_pred, aux_convs.{k}} (mmcv ConvModule .conv / .gn)
                                      -> rpn_head.{loc,seg}_conv{i}, rpn_head.
                                         localization_fpn.{l{i}_conv{j}, conv_pred,
                                         aux_conv{k}} .Conv_0 / .GroupNorm_0
  roi_head.mask_head.{s}.* (mask_head.{s}.* in a video checkpoint)
                                      -> roi_head.mask_head_{s}.*: kernel_update_conv
                                         (same names), attention, ffn.layers.{0.0,1}
                                         -> ffn.Dense_{0,1}, {cls,mask}_fcs.{0,1} ->
                                         .{Dense_0,LayerNorm_0}, fc_cls, fc_mask,
                                         feat_transform.conv -> feat_transform
  nn.MultiheadAttention in_proj_weight [3C, C], in_proj_bias, out_proj
                                      -> query / key / value (rows 0:C, C:2C,
                                         2C:3C), out
  attention_previous, link_ffn, their norms (the last stage's only)
                                      -> attention_previous, link_ffn_previous,
                                         ..._norm
  embed_fcs.{0,1}, fc_embed, track_head.{fcs.{i}, fc_embed}
                                      -> track_embed.{embed_fc0, embed_ln0, fc_embed,
                                         track_fc{i}, track_fc_embed}

`import_torch_swin`: official Swin checkpoints (Microsoft naming). The
port's Swin keeps the official layouts (PatchMerging's slice order x0 =
even/even, x1 = odd/even, x2 = even/odd, x3 = odd/odd), so every weight is
a plain copy under a new name:

  patch_embed.proj.*                  -> patch_embed.*
  patch_embed.norm.*                  -> patch_norm.*
  absolute_pos_embed [1, N, C]        -> absolute_pos_embed [1, g, g, C]
  layers.{i}.blocks.{j}.{norm1, norm2, attn.qkv, attn.proj,
      attn.relative_position_bias_table}
                                      -> stage{i}_pairs.{j//2}.blk{j%2}.<same>
  layers.{i}.blocks.{j}.mlp.fc{1,2}.* -> stage{i}_pairs.{j//2}.blk{j%2}.mlp_fc{1,2}.*
  layers.{i}.downsample.{norm, reduction}.*
                                      -> downsample{i}.{norm, reduction}.*
  norm{i}.* (detection checkpoints)   -> out_norm{i}.*

A `backbone.` prefix (a detector's checkpoint) is stripped, keeping only
the backbone's keys. Classification checkpoints' final `norm.` and `head.`
are skipped (their per-stage out_norms keep the model's init), as are the
computed buffers (`relative_position_index`, `attn_mask`) and BatchNorm
step counters.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import torch

from video_knet_tpu_torch.utils.checkpoint import (
    TrackedStateDict,
    _tensor,
    import_torch_fpn,
    import_torch_resnet,
)

# keys of reference checkpoints that carry nothing the port loads: BatchNorm
# step counters, buffers computed at run time, classification heads
_IGNORABLE = re.compile(
    r"(num_batches_tracked$|relative_position_index$|attn_mask$|^head\.|^norm\.|"
    r"rpn_head\.localization_fpn\.positional_encoding)")
_RULES = (
    (re.compile(r"^patch_embed\.proj\.(weight|bias)$"), lambda m: f"patch_embed.{m[1]}"),
    (re.compile(r"^patch_embed\.norm\.(weight|bias)$"), lambda m: f"patch_norm.{m[1]}"),
    (re.compile(r"^absolute_pos_embed$"), lambda m: "absolute_pos_embed"),
    (re.compile(r"^layers\.(\d+)\.blocks\.(\d+)\.(norm1|norm2|attn\.qkv|attn\.proj)\.(weight|bias)$"),
     lambda m: f"stage{m[1]}_pairs.{int(m[2]) // 2}.blk{int(m[2]) % 2}.{m[3]}.{m[4]}"),
    (re.compile(r"^layers\.(\d+)\.blocks\.(\d+)\.attn\.relative_position_bias_table$"),
     lambda m: f"stage{m[1]}_pairs.{int(m[2]) // 2}.blk{int(m[2]) % 2}."
               "attn.relative_position_bias_table"),
    (re.compile(r"^layers\.(\d+)\.blocks\.(\d+)\.mlp\.fc([12])\.(weight|bias)$"),
     lambda m: f"stage{m[1]}_pairs.{int(m[2]) // 2}.blk{int(m[2]) % 2}.mlp_fc{m[3]}.{m[4]}"),
    (re.compile(r"^layers\.(\d+)\.downsample\.(norm|reduction)\.(weight|bias)$"),
     lambda m: f"downsample{m[1]}.{m[2]}.{m[3]}"),
    (re.compile(r"^norm(\d+)\.(weight|bias)$"), lambda m: f"out_norm{m[1]}.{m[2]}"),
)


def import_torch_swin(state_dict: Mapping[str, torch.Tensor], *,
                      strict: bool = False) -> dict[str, torch.Tensor]:
    """Official Swin state dict -> {port `SwinTransformer` state_dict key:
    tensor}. Load it with `module.load_state_dict(out, strict=False)` (a
    classification checkpoint has no per-stage out_norms). strict: raise on
    any key that is neither mapped nor ignorable."""
    raw = dict(state_dict)
    if any(k.startswith("backbone.") for k in raw):
        raw = {k[len("backbone."):]: v for k, v in raw.items() if k.startswith("backbone.")}
    out: dict[str, torch.Tensor] = {}
    leftover = []
    for key, v in raw.items():
        for pat, name in _RULES:
            m = pat.match(key)
            if m:
                out[name(m)] = torch.as_tensor(v, dtype=torch.float32).clone()
                break
        else:
            if not _IGNORABLE.search(key):
                leftover.append(key)
    pe = out.get("absolute_pos_embed")
    if pe is not None and pe.dim() == 3:  # official [1, N, C] -> [1, g, g, C]
        g = int(round(pe.shape[1] ** 0.5))
        out["absolute_pos_embed"] = pe.reshape(1, g, g, pe.shape[-1])
    if leftover and strict:
        raise KeyError(f"import_torch_swin: {len(leftover)} unconsumed keys, e.g. "
                       f"{sorted(leftover)[:10]}")
    return out


def _check_consumed(sd: TrackedStateDict, strict: bool, what: str) -> list[str]:
    """The keys of `sd` never read and not ignorable; with `strict`, raise
    if there is any."""
    leftover = sorted(k for k in sd if k not in sd.used and not _IGNORABLE.search(k))
    if leftover and strict:
        raise KeyError(f"{what}: {len(leftover)} unconsumed checkpoint keys, "
                       f"e.g. {leftover[:8]}")
    return leftover


def _linear(sd, src: str, dst: str, out: dict, bias: bool = True) -> None:
    """A Linear, LayerNorm, GroupNorm or conv: weight (and bias) by name."""
    out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
    if bias and f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])


def _convmodule(sd, src: str, dst: str, out: dict) -> None:
    """mmcv ConvModule (.conv [+ .gn]) -> the port's ConvNormAct
    (.Conv_0 [+ .GroupNorm_0])."""
    _linear(sd, f"{src}.conv", f"{dst}.Conv_0", out)
    if f"{src}.gn.weight" in sd:
        _linear(sd, f"{src}.gn", f"{dst}.GroupNorm_0", out)


def _mha(sd, src: str, dst: str, out: dict) -> None:
    """torch nn.MultiheadAttention -> the port's MultiHeadAttention: the
    packed in_proj [3C, C] splits by rows into query, key and value."""
    w, b = sd[f"{src}.in_proj_weight"], sd[f"{src}.in_proj_bias"]
    c = w.shape[1]
    for i, name in enumerate(("query", "key", "value")):
        out[f"{dst}.{name}.weight"] = _tensor(w[i * c:(i + 1) * c])
        out[f"{dst}.{name}.bias"] = _tensor(b[i * c:(i + 1) * c])
    _linear(sd, f"{src}.out_proj", f"{dst}.out", out)


def _count(sd, key: str, step: int = 1) -> int:
    """How many of `key.format(step * i)` for i = 0, 1, ... the dict holds
    in a row."""
    i = 0
    while key.format(step * i) in sd:
        i += 1
    return i


def import_torch_knet(state_dict: Mapping[str, torch.Tensor], *,
                      strict: bool = False) -> dict[str, torch.Tensor]:
    """An mmdet image or Video K-Net state dict -> {`KNet` state_dict key:
    tensor}; `utils/checkpoint.image_to_video_params` moves the stages onto
    `VideoKNet`'s keys. A joint-train checkpoint's link layers map to the
    last stage only: the reference config repeats them over every stage,
    but only the last stage's run (`kernel_iter_head.py:302-309,453-456`),
    so the earlier copies are read and dropped. Every count (stages, loc /
    seg / aux convs, cls / mask fcs, track-head fcs) is read off the dict's
    keys; a count the model does not share fails its strict
    `load_state_dict`. strict: raise on any key that is neither read nor
    ignorable."""
    sd = TrackedStateDict(dict(state_dict))
    out: dict[str, torch.Tensor] = {}
    if any(k.startswith("backbone.patch_embed.") for k in sd):
        # a Swin backbone (the Swin-B VIP-Seg / KITTI-STEP joint-train checkpoints)
        bb_keys = [k for k in sd if k.startswith("backbone.")]
        swin = import_torch_swin({k: dict.__getitem__(sd, k) for k in bb_keys}, strict=strict)
        out.update({f"backbone.{k}": v for k, v in swin.items()})
        for k in bb_keys:
            sd.mark(k)
    else:
        out.update({f"backbone.{k}": v
                    for k, v in import_torch_resnet(sd, prefix="backbone.").items()})
    out.update({f"neck.{k}": v for k, v in import_torch_fpn(sd, prefix="neck.").items()})

    out["rpn_head.init_kernels"] = _tensor(sd["rpn_head.init_kernels.weight"][:, :, 0, 0])
    _linear(sd, "rpn_head.conv_seg", "rpn_head.conv_seg", out)
    for i in range(_count(sd, "rpn_head.loc_convs.{}.conv.weight")):
        _convmodule(sd, f"rpn_head.loc_convs.{i}", f"rpn_head.loc_conv{i}", out)
    for i in range(_count(sd, "rpn_head.seg_convs.{}.conv.weight")):
        _convmodule(sd, f"rpn_head.seg_convs.{i}", f"rpn_head.seg_conv{i}", out)
    loc = "rpn_head.localization_fpn"
    for key in list(sd):
        m = re.match(rf"{re.escape(loc)}\.convs_all_levels\.(\d+)\.conv(\d+)\.conv\.weight$", key)
        if m:
            i, j = m.groups()
            _convmodule(sd, f"{loc}.convs_all_levels.{i}.conv{j}", f"{loc}.l{i}_conv{j}", out)
    _convmodule(sd, f"{loc}.conv_pred", f"{loc}.conv_pred", out)
    for k in range(_count(sd, loc + ".aux_convs.{}.conv.weight")):
        _convmodule(sd, f"{loc}.aux_convs.{k}", f"{loc}.aux_conv{k}", out)

    num_stages = max(_count(sd, "roi_head.mask_head.{}.fc_mask.weight"),
                     _count(sd, "mask_head.{}.fc_mask.weight"))
    for s in range(num_stages):
        pre = f"roi_head.mask_head.{s}"
        if f"{pre}.fc_mask.weight" not in sd:
            pre = f"mask_head.{s}"  # a video checkpoint holds its stages at the top
        dst = f"roi_head.mask_head_{s}"
        if f"{pre}.feat_transform.conv.weight" in sd:
            _linear(sd, f"{pre}.feat_transform.conv", f"{dst}.feat_transform", out)
        ku = "kernel_update_conv"
        for name in ("dynamic_layer", "input_layer", "input_gate", "update_gate", "fc_layer",
                     "norm_in", "norm_out", "input_norm_in", "input_norm_out", "fc_norm"):
            _linear(sd, f"{pre}.{ku}.{name}", f"{dst}.{ku}.{name}", out)
        _mha(sd, f"{pre}.attention.attn", f"{dst}.attention", out)
        _linear(sd, f"{pre}.attention_norm", f"{dst}.attention_norm", out)
        _linear(sd, f"{pre}.ffn.layers.0.0", f"{dst}.ffn.Dense_0", out)
        _linear(sd, f"{pre}.ffn.layers.1", f"{dst}.ffn.Dense_1", out)
        _linear(sd, f"{pre}.ffn_norm", f"{dst}.ffn_norm", out)
        for branch in ("cls_fcs", "mask_fcs"):
            # mmdet's Sequential of (Linear, LN, ReLU) repeats: Linear i at 3i
            for i in range(_count(sd, f"{pre}.{branch}.{{}}.weight", step=3)):
                _linear(sd, f"{pre}.{branch}.{3 * i}", f"{dst}.{branch}.Dense_{i}", out,
                        bias=False)
                _linear(sd, f"{pre}.{branch}.{3 * i + 1}", f"{dst}.{branch}.LayerNorm_{i}", out)
        _linear(sd, f"{pre}.fc_cls", f"{dst}.fc_cls", out)
        _linear(sd, f"{pre}.fc_mask", f"{dst}.fc_mask", out)
        if f"{pre}.attention_previous.attn.in_proj_weight" in sd:
            tgt = out if s == num_stages - 1 else {}  # the dead copies are dropped
            _mha(sd, f"{pre}.attention_previous.attn", f"{dst}.attention_previous", tgt)
            _linear(sd, f"{pre}.attention_previous_norm", f"{dst}.attention_previous_norm", tgt)
            _linear(sd, f"{pre}.link_ffn.layers.0.0", f"{dst}.link_ffn_previous.Dense_0", tgt)
            _linear(sd, f"{pre}.link_ffn.layers.1", f"{dst}.link_ffn_previous.Dense_1", tgt)
            _linear(sd, f"{pre}.link_ffn_norm", f"{dst}.link_ffn_previous_norm", tgt)

    # the joint-train model's track embedding: embed_fcs (Linear without a
    # bias, LN) and fc_embed (joint_train.py:114-126), then the track head's
    # MLP (track_heads.py:600-642; 2 fcs in the release, 1 in "short_track_fc")
    if "fc_embed.weight" in sd:
        _linear(sd, "embed_fcs.0", "track_embed.embed_fc0", out, bias=False)
        _linear(sd, "embed_fcs.1", "track_embed.embed_ln0", out)
        _linear(sd, "fc_embed", "track_embed.fc_embed", out)
        if "track_head.fc_embed.weight" in sd:
            for i in range(_count(sd, "track_head.fcs.{}.weight")):
                _linear(sd, f"track_head.fcs.{i}", f"track_embed.track_fc{i}", out)
            _linear(sd, "track_head.fc_embed", "track_embed.track_fc_embed", out)

    _check_consumed(sd, strict, "import_torch_knet")
    return out
