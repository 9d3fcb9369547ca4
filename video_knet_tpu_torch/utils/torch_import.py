"""Official Swin checkpoints (Microsoft naming) onto the port's Swin.

Counterpart of `video_knet_tpu/utils/torch_import.py:import_torch_swin`.
The port's Swin keeps the official layouts (Linear [out, in], conv OIHW,
PatchMerging's slice order x0 = even/even, x1 = odd/even, x2 = even/odd,
x3 = odd/odd), so every weight is a plain copy under a new name:

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

_IGNORABLE = re.compile(
    r"(num_batches_tracked$|relative_position_index$|attn_mask$|^head\.|^norm\.)")
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
