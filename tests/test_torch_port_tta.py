"""Test-time augmentation of the port against the JAX package, on the CPU.

`video_knet_tpu_torch/data/tta.py` and `video_knet_tpu/data/tta.py` fed the
same seeded numpy frames: the variant enumeration of
`MultiScaleFlipAugVideo` (both scale modes, every flip direction) through
`default_video_transforms` and the things-first LUT, exactly (arrays equal
element for element). The fused semantic maps of `make_tta_semantic_fn`
are held against JAX's in `tests/test_torch_port_cli.py`, through the
function the JAX `test_step` CLI makes; here, the port's alone on the
trained tiny model.
"""

import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)

from video_knet_tpu.data import tta as jtta
from video_knet_tpu_torch.data import tta as ttta
from video_knet_tpu_torch.tools import trained_golden as tg

SCALES = (0.75, 1.0, 1.25)


def _frames(n=2, hw=(37, 53), seed=0):
    rng = np.random.RandomState(seed)
    return [{"img": rng.randint(0, 256, (*hw, 3)).astype(np.uint8)} for _ in range(n)]


def _assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


@pytest.mark.parametrize("mode,scale", [
    ("img_scale", [(32, 48), (64, 96)]),
    ("img_scale", (48, 64)),
    ("scale_factor", [0.5, 1.0, 1.5]),
    ("scale_factor", 0.75),
])
@pytest.mark.parametrize("flip,direction", [
    (False, "horizontal"), (True, "horizontal"), (True, "vertical"), (True, "diagonal"),
    (True, ["horizontal", "vertical", "diagonal"]),
])
def test_multi_scale_flip_aug_matches_jax(mode, scale, flip, direction):
    """Every (scale, flip) variant of two frames: images, content sizes,
    flags and scales equal, in the same order."""
    frames = _frames()
    kw = {mode: scale, "flip": flip, "flip_direction": direction}
    got = ttta.MultiScaleFlipAugVideo(ttta.default_video_transforms, **kw)(frames)
    want = jtta.MultiScaleFlipAugVideo(jtta.default_video_transforms, **kw)(frames)
    _assert_same(got, want)
    n_scales = len(scale) if isinstance(scale, list) else 1
    n_flips = 1 + (len(direction) if isinstance(direction, list) else 1) * flip
    assert len(got["img"]) == n_scales * n_flips
    assert got["img"][0].shape[0] == len(frames)


def test_multi_scale_flip_aug_needs_one_scale_kind():
    for kw in ({}, {"img_scale": (32, 32), "scale_factor": 1.0}):
        with pytest.raises(ValueError, match="only one"):
            ttta.MultiScaleFlipAugVideo(ttta.default_video_transforms, **kw)


@pytest.mark.parametrize("num_thing,num_stuff,thing_ids", [
    (2, 17, (11, 13)), (2, 17, None), (8, 11, tuple(range(11, 19))), (58, 66, None),
    (3, 5, (0, 4, 7)),
])
def test_things_first_lut_matches_jax(num_thing, num_stuff, thing_ids):
    got = ttta.things_first_to_dataset_lut(num_thing, num_stuff, thing_ids)
    want = jtta.things_first_to_dataset_lut(num_thing, num_stuff, thing_ids)
    _assert_same(got, want)
    assert sorted(got) == list(range(num_thing + num_stuff))


@pytest.mark.parametrize("flip", [False, True])
def test_tta_at_one_scale_is_the_plain_argmax(flip):
    """At scale 1.0 the fused map is the argmax of the forward's seg logits
    bilinearly resized to the base grid, plus, with flip, the flipped
    input's logits unflipped."""
    from video_knet_tpu_torch.data.transforms import bilinear_resize, keep_ratio_resize_pad

    model = tg.tiny_model("cpu")
    cfg = tg.tiny_cfg()
    fn = ttta.make_tta_semantic_fn(model, cfg, tg.HW, (1.0,), flip=flip, device="cpu")
    rgb = tg.sequence_images()[3]
    x, _ = keep_ratio_resize_pad(rgb, tg.HW)
    prev = torch.zeros((1, cfg.num_proposals + cfg.num_stuff_classes, 1, 64))

    def logits(img):
        with torch.no_grad():
            seg = model.test_step(torch.from_numpy(img)[None], prev, True)["rpn_out"].seg_preds
        return bilinear_resize(seg[0].numpy(), tg.HW)

    acc = logits(x)
    if flip:
        acc = acc + bilinear_resize(logits(x[:, ::-1].copy())[:, ::-1], tg.HW)
    np.testing.assert_array_equal(fn(rgb), np.argmax(acc, axis=-1))


def test_tta_fn_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttta.make_tta_semantic_fn(tg.tiny_model("cpu"), tg.tiny_cfg(), tg.HW, SCALES)


def test_near_ties_marks_pixels_within_twice_the_error():
    logits = np.zeros((2, 3, 4), np.float32)
    logits[..., 0] = [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]]
    logits[..., 2] = [[0.5, 0.99, 1.0], [0.98, 0.0, 1.02]]
    np.testing.assert_array_equal(ttta.near_ties(logits, 0.01),
                                  [[False, True, True], [True, False, True]])
