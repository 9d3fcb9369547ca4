"""The port's VIS modules (`models/vis/clip_head.py`, `volume_head.py`, the
3-D positional encoding, the clip path of the semantic FPN) against the JAX
package, on the CPU, without a backbone; `frame_gt_from_clip` and the
weight converter on KNetVIS trees. The slice as a whole:
`tests/test_torch_port_vis.py`.

- `sine_positional_encoding_3d` within 1e-6 relative; the semantic FPN with
  `num_frames` (B=2 clips of T=2, ragged levels: bilinear alignment) within
  1e-5 relative.
- `ClipKernelHead` on the same features, four variants: `mean` (the
  release config), `attention`, `attention_pos` with `with_mask_init`, and
  `mean` with `direct_tracker`; every stage's cls_score, mask_preds and
  object_feats within 1e-5 relative. `ClipVolumeKernelHead` within 1e-5
  relative. Weights made by the port (flax's default initializers),
  carried to flax, norms perturbed; JAX's apply jitted once a module.
- `frame_gt_from_clip` bit-equal.
- `utils/convert.py` on the tiny KNetVIS (`train_check.vis_check_cfg`)
  trees, `mean`, `attention_pos` + `with_mask_init`, and `volume`: the
  port's tree is `jax.eval_shape` of JAX's init, loading is strict, and
  the round trip is bit-equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_common import assert_rel_close, perturb_norms, port_of, t

from video_knet_tpu.config_vis import VISConfig as JVISConfig
from video_knet_tpu.models import layers as jl
from video_knet_tpu.models.semantic_fpn import SemanticFPN as JSemanticFPN
from video_knet_tpu.models.vis import clip_head as jclip
from video_knet_tpu.models.vis import knet_vis as jvis
from video_knet_tpu.models.vis.volume_head import ClipVolumeKernelHead as JVolumeHead
from video_knet_tpu_torch.config_vis import VISConfig
from video_knet_tpu_torch.models import layers as tl
from video_knet_tpu_torch.models.semantic_fpn import SemanticFPN
from video_knet_tpu_torch.models.vis import clip_head as tclip
from video_knet_tpu_torch.models.vis import knet_vis as tvis
from video_knet_tpu_torch.models.vis.volume_head import ClipVolumeKernelHead
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.train import vis as train_vis
from video_knet_tpu_torch.utils.convert import state_dict_to_flax

HW = (64, 96)
T = 2


def _flax_of(model: torch.nn.Module) -> dict:
    flat = state_dict_to_flax(model, model.state_dict())
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Random weights with flax's default initializers (quicker than JAX's
    init; the model's tree is held against JAX's init shapes below)."""
    tl.init_parameters(module, torch.Generator().manual_seed(seed))
    return module


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(tree).items()}


def _cfgs(**change):
    """The check config of both packages, with `change` applied."""
    pair = [dataclasses.replace(train_check.vis_check_cfg(c()), **change)
            for c in (JVISConfig, VISConfig)]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    return pair


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("tt,h,w,nf", [(5, 12, 20, 128), (2, 3, 4, 32)])
def test_sine_positional_encoding_3d_matches_jax(tt, h, w, nf):
    want = jax.jit(jl.sine_positional_encoding_3d, static_argnums=(0, 1, 2, 3))(tt, h, w, nf)
    got = tl.sine_positional_encoding_3d(tt, h, w, nf)
    assert got.shape == (tt, h, w, 2 * nf)
    assert_rel_close(got, want, 1e-6, "pe3d")


def test_semantic_fpn_clip_path_matches_jax():
    """Two clips of two frames; levels of a 72x104 input (not multiples of
    32): the last level upsamples to 12x16 and is aligned to 9x13."""
    rng = np.random.RandomState(3)
    shapes = [(18, 26), (9, 13), (5, 7), (3, 4)]
    feats = [rng.randn(2 * T, *s, 64).astype(np.float32) for s in shapes]
    tm = _seeded(SemanticFPN(64, 64, 64))
    v = perturb_norms(_flax_of(tm))
    tm = port_of(tm, v)
    with torch.no_grad():
        outs = tm([t(f) for f in feats], num_frames=T)
        plain = tm([t(f) for f in feats])
    want = jax.jit(JSemanticFPN(feat_channels=64, out_channels=64, num_frames=T).apply)(v, feats)
    for i, (a, b) in enumerate(zip(outs, want)):
        assert a.shape == (2 * T, 9, 13, 64)
        assert_rel_close(a, b, 1e-5, f"clip fpn out {i}")
    assert not torch.allclose(outs[0], plain[0])  # the temporal term changes the features


# ------------------------------------------------------------ clip heads

HEAD_VARIANTS = {
    "mean": dict(),
    "attention": dict(query_merge_method="attention"),
    "attention_pos_mask_init": dict(query_merge_method="attention_pos", with_mask_init=True),
    "mean_direct": dict(direct_tracker=True),
}


@pytest.fixture(scope="module")
def head_inputs():
    rng = np.random.RandomState(0)
    b, n, c, h, w = 2, 8, 64, 8, 12
    return dict(
        x=rng.randn(b, T, h, w, c).astype(np.float32),
        kernels=rng.randn(b, T, n, c).astype(np.float32),
        masks=(2.0 * rng.randn(b, T, n, h, w)).astype(np.float32),
        direct=rng.randn(n, c).astype(np.float32))


@pytest.mark.parametrize("variant", sorted(HEAD_VARIANTS))
def test_clip_kernel_head_matches_jax(head_inputs, variant):
    opts = dict(query_merge_method="mean", with_mask_init=False, direct_tracker=False)
    opts.update(HEAD_VARIANTS[variant])
    jcfg, cfg = _cfgs(**opts)
    kw = dict(num_stages=cfg.tracker_num_stages, assign_stages=cfg.tracker_assign_stages,
              num_proposals=cfg.num_proposals, query_merge_method=cfg.query_merge_method,
              with_mask_init=cfg.with_mask_init)
    i = head_inputs
    args = (i["x"], i["kernels"], i["masks"])
    direct = i["direct"] if cfg.direct_tracker else None
    tm = _seeded(tclip.ClipKernelHead(cfg.head, merge_queries=not cfg.direct_tracker, **kw))
    v = perturb_norms(_flax_of(tm))
    want = jax.jit(functools.partial(jclip.ClipKernelHead(jcfg.head, **kw).apply,
                                     direct_kernels=direct))(v, *args)
    tm = port_of(tm, v)
    with torch.no_grad():
        got = tm(*(t(a) for a in args), direct_kernels=None if direct is None else t(direct))
    assert len(got) == len(want) == 3
    for s, (a, b) in enumerate(zip(got, want)):
        assert (a.cls_score is None) == (b.cls_score is None) == (s >= 2)
        if b.cls_score is not None:
            assert_rel_close(a.cls_score, b.cls_score, 1e-5, f"{variant} s{s} cls")
        assert a.mask_preds.shape == (2, T, 8, 8, 12)
        assert_rel_close(a.mask_preds, b.mask_preds, 1e-5, f"{variant} s{s} masks")
        assert_rel_close(a.scaled_mask_preds, b.scaled_mask_preds, 1e-5, f"{variant} s{s} scaled")
        assert_rel_close(a.object_feats, b.object_feats, 1e-5, f"{variant} s{s} feats")


def test_clip_volume_kernel_head_matches_jax():
    rng = np.random.RandomState(4)
    jcfg, cfg = _cfgs(kernel_head_mode="volume")
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    feats = [rng.randn(2 * T, *s, 64).astype(np.float32) for s in shapes]
    tm = _seeded(ClipVolumeKernelHead(cfg.rpn, in_channels=64))
    v = perturb_norms(_flax_of(tm))
    want = jax.jit(functools.partial(JVolumeHead(jcfg.rpn).apply, num_frames=T))(v, feats)
    tm = port_of(tm, v)
    with torch.no_grad():
        got = tm([t(f) for f in feats], num_frames=T)
    assert got.tube_mask_preds.shape == (2, T, 8, 8, 12)
    for f in want._fields:
        assert_rel_close(getattr(got, f), getattr(want, f), 1e-5, f)


# ------------------------------------------------------- GT and weights


def test_frame_gt_from_clip_is_bit_equal():
    cfg = _cfgs()[1]
    gt = train_vis.make_synthetic_clip_gt(cfg, 2, 3, (16, 24), seed=5, device="cpu")
    want = jvis.frame_gt_from_clip(jvis.ClipGT(*(jnp.asarray(x.numpy()) for x in gt)))
    got = tvis.frame_gt_from_clip(gt)
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, f)
    # a slot absent from a frame is invalid there, valid in the tube
    assert bool((gt.valid[:, None] & ~got.valid.reshape(2, 3, -1)).any())


@pytest.mark.parametrize("variant", ["mean", "attention_pos_mask_init", "volume"])
def test_convert_knet_vis_tree_strict_and_round_trip(variant):
    """The port's tree is JAX's init tree, leaf for leaf and shape for shape."""
    jcfg, cfg = _cfgs(**{"volume": dict(kernel_head_mode="volume"), **HEAD_VARIANTS}[variant])
    model = tvis.KNetVIS(cfg, device="cpu")
    shapes = _shapes(jax.eval_shape(jvis.KNetVIS(jcfg).init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, T, *HW, 3))))
    flat = state_dict_to_flax(model, model.state_dict())
    assert {tuple(k.split("/")): v.shape for k, v in flat.items()} == shapes
    tops = {k.split("/")[1] for k in flat}
    assert tops == {"backbone", "neck", "rpn_head", "tracker"} | (
        set() if variant == "volume" else {"roi_head"})
    if cfg.query_merge_method == "attention_pos":
        assert {"params/tracker/init_query", "params/tracker/query_pos",
                "params/tracker/fc_mask_init/kernel"} <= set(flat)
    # flax -> port (strict) -> flax is bit-equal
    rng = np.random.RandomState(6)
    variables = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
    port_of(model, variables)
    back = state_dict_to_flax(model, model.state_dict())
    assert set(back) == set(variables)
    for k, v in variables.items():
        assert back[k].tobytes() == v.tobytes(), k
    with pytest.raises(KeyError):  # strict: a missing leaf raises
        port_of(model, {k: v for k, v in variables.items() if "tracker" not in k})
