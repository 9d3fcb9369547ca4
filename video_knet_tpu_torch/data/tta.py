"""Test-time augmentation: the multi-scale / flip wrapper and semantic fusion.

Counterpart of `video_knet_tpu/data/tta.py` (the reference's
mmtrack/pipelines/test_time_aug.py:11-108, `MultiScaleFlipAugVideo`):

- `MultiScaleFlipAugVideo` enumerates every (scale, flip) variant of a list
  of per-frame dicts through a transform callable, scale-major with the
  un-flipped variant first; `default_video_transforms` is the keep-ratio
  resize + normalize + pad + flip stack of the reference's example config.
- `make_tta_semantic_fn` fuses the semantic logits of the variants: one full
  `VideoKNet.test_step` a variant (zero carried kernels, `is_first=True`),
  `rpn_out.seg_preds[0]` copied to the host as fp32; the rest stays on the
  host as in the reference package: unflip, crop the padding at the logit
  grid, `bilinear_resize` to the base grid, a float32 sum in variant order,
  argmax.
- `things_first_to_dataset_lut` maps the model's things-first classes to the
  dataset's label space.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from video_knet_tpu_torch.data.transforms import bilinear_resize, keep_ratio_resize_pad
from video_knet_tpu_torch.utils.device import resolve_device


class MultiScaleFlipAugVideo:
    """Enumerates (scale x flip) variants of a list of per-frame dicts.

    Exactly one of img_scale / scale_factor; `transforms` is a callable over
    the per-frame dict list returning a data dict; the output is a dict whose
    values are lists, one entry per augmentation, ordered scale-major with
    the un-flipped variant first (reference :87-102).
    """

    def __init__(
        self,
        transforms: Callable[[list[dict]], dict],
        img_scale=None,
        scale_factor=None,
        flip: bool = False,
        flip_direction: str | Sequence[str] = "horizontal",
    ):
        if (img_scale is None) == (scale_factor is None):
            raise ValueError("Must have but only one variable can be set")
        self.transforms = transforms
        if img_scale is not None:
            self.img_scale = img_scale if isinstance(img_scale, list) else [img_scale]
            self.scale_key = "scale"
        else:
            self.img_scale = scale_factor if isinstance(scale_factor, list) else [scale_factor]
            self.scale_key = "scale_factor"
        self.flip = flip
        self.flip_direction = (list(flip_direction)
                               if isinstance(flip_direction, (list, tuple))
                               else [flip_direction])

    def __call__(self, results: list[dict]) -> dict:
        aug_data = []
        flip_args = [(False, None)]
        if self.flip:
            flip_args += [(True, d) for d in self.flip_direction]
        for scale in self.img_scale:
            for flip, direction in flip_args:
                variant = []
                for r in results:
                    r = dict(r)
                    r[self.scale_key] = scale
                    r["flip"] = flip
                    r["flip_direction"] = direction
                    variant.append(r)
                aug_data.append(self.transforms(variant))
        out = {key: [] for key in aug_data[0]}
        for data in aug_data:
            for key, val in data.items():
                out[key].append(val)
        return out


def default_video_transforms(variant: list[dict]) -> dict:
    """Keep-ratio resize into the scale canvas + normalize + pad, then the
    variant's flip, stacking frames on a new time axis."""
    imgs, contents = [], []
    for r in variant:
        th, tw = r["scale"] if "scale" in r else (
            round(r["img"].shape[0] * r["scale_factor"]),
            round(r["img"].shape[1] * r["scale_factor"]),
        )
        x, content = keep_ratio_resize_pad(r["img"], (int(th), int(tw)))
        if r.get("flip"):
            if r.get("flip_direction") in (None, "horizontal"):
                x = x[:, ::-1]
            elif r["flip_direction"] == "vertical":
                x = x[::-1]
            else:  # diagonal
                x = x[::-1, ::-1]
        imgs.append(x)
        contents.append(content)
    return {
        "img": np.stack(imgs),
        "content_hw": contents,
        "flip": variant[0].get("flip", False),
        "flip_direction": variant[0].get("flip_direction"),
        "scale": variant[0].get("scale", variant[0].get("scale_factor")),
    }


def _round32(v: float) -> int:
    return max(32, int(round(v / 32)) * 32)


def make_tta_semantic_fn(model, cfg, base_hw, scales, flip: bool = True,
                         device: str | torch.device | None = None):
    """Multi-scale / flip semantic-logit fusion over `model` (a `VideoKNet`).

    Returns fn(rgb_uint8 [H, W, 3]) -> [base_h, base_w] int32 label map in the
    model's things-first class space: the argmax over the variants' summed
    seg logits, which `fn.logits(rgb)` returns. Each scale's canvas is
    `base_hw` times the scale, rounded to a multiple of 32; the flipped
    variant is the input flipped on the host and its logits unflipped there.
    `device` (CUDA unless named) must be where `model` lives."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model lives on {next(model.parameters()).device}, asked for {device}")
    n_tot = cfg.num_proposals + cfg.num_stuff_classes
    k = cfg.head.conv_kernel_size ** 2
    prev = torch.zeros((1, n_tot, k, cfg.head.in_channels), dtype=torch.float32, device=device)

    @torch.inference_mode()
    def seg_fwd(img: np.ndarray) -> np.ndarray:
        out = model.test_step(torch.from_numpy(img).to(device), prev, True)
        return out["rpn_out"].seg_preds[0].float().cpu().numpy()  # [h/4, w/4, C] logits

    canvases = [(_round32(base_hw[0] * s), _round32(base_hw[1] * s)) for s in scales]

    def fused_logits(rgb: np.ndarray) -> np.ndarray:
        acc = None
        for th, tw in canvases:
            x, (ch, cw) = keep_ratio_resize_pad(rgb, (th, tw))
            variants = [x] + ([x[:, ::-1].copy()] if flip else [])
            for vi, v in enumerate(variants):
                logits = np.asarray(seg_fwd(v[None]), np.float32)
                if vi == 1:
                    logits = logits[:, ::-1]
                # crop the padding at the logit grid, then resize to the base grid
                gh = max(1, round(ch / th * logits.shape[0]))
                gw = max(1, round(cw / tw * logits.shape[1]))
                logits = bilinear_resize(logits[:gh, :gw], base_hw)
                acc = logits if acc is None else acc + logits
        return acc

    def fuse(rgb: np.ndarray) -> np.ndarray:
        return np.argmax(fused_logits(rgb), axis=-1).astype(np.int32)

    fuse.logits = fused_logits  # the summed [base_h, base_w, C] logits
    return fuse


def things_first_to_dataset_lut(num_thing: int, num_stuff: int,
                                thing_ids_in_orig=None) -> np.ndarray:
    """LUT from the model's things-first class space to the dataset label
    space (the mapping of `inference.semantic_map_from_panoptic`: thing k ->
    thing_ids_in_orig[k]; stuff s -> its original index skipping thing
    slots; the identity when thing_ids_in_orig is None)."""
    lut = np.zeros(num_thing + num_stuff, np.int32)
    for k in range(num_thing):
        lut[k] = thing_ids_in_orig[k] if thing_ids_in_orig is not None else k
    for s in range(num_stuff):
        if thing_ids_in_orig is None:
            lut[num_thing + s] = num_thing + s
        else:
            cls = s
            for tid in thing_ids_in_orig:
                if cls >= tid:
                    cls += 1
            lut[num_thing + s] = cls
    return lut


def near_ties(logits: np.ndarray, err: float) -> np.ndarray:
    """[H, W] bool: the pixels of fused `logits` [H, W, C] whose top two
    classes lie within 2 * `err` of each other, where an argmax may flip when
    every logit moves by up to `err` (another device's arithmetic)."""
    top2 = np.partition(logits, -2, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= 2 * err
