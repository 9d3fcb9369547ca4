"""The port's DetectoRS / RFP backbones (`models/rfp.py`) against the JAX
package, on the CPU.

Weights are the port's seeded init with the leaves the reference
initializes at zero drawn nonzero (`train_check.draw_zero_init_leaves`:
every `rfp_conv`, SAC's `weight_diff`), so the feedback path and SAC's
atrous branch are seen; carried to flax by `utils/convert.py` (the tree
held against `jax.eval_shape` of JAX's init), norms and BN statistics
perturbed (`perturb_norms`), then loaded back. Forwards within 1e-5 of the
output's scale (fp32 sums in another order) unless stated:
- `SAConv` at stride 1 and 2 (odd sizes: the switch's stride-2 1x1 and
  the (d, d)-padded dilated convs must agree on the output grid);
- `DetectoRSBottleneck`, SAC and plain, stride 2, with an RFP feature;
- `DetectoRSResNet(depth=50)` at 32x32 with RFP features (the stem's
  explicit padding and -inf max pool);
- `SwinTransformerRFP('tiny')` at 64x96 with RFP features, and `RFP` over
  `swin_tiny_rfp` (both passes, the fusion);
- gradients of `SAConv` and of a SAC + RFP bottleneck against `jax.grad`
  (the port replaying JAX's ReLU decisions), within 1e-4 of each leaf's
  scale;
- the image `KNet` with the check model's 64-channel heads and backbone
  `swin_t_rfp` at 64x96: every output within 1e-4 of its scale, the
  panoptic decode's integers equal;
- the parameter trees of both full-width RFP presets equal JAX's
  (52,049,565 and 100,626,696 parameters).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_common import (
    assert_rel_close,
    flax_tree,
    jax_tree_shapes,
    jit_apply,
    perturb_norms,
    port_of,
    seeded_inputs,
    shared_weights,
    t,
)

from video_knet_tpu import configs as jconfigs
from video_knet_tpu.config import KNetConfig as JKNetConfig
from video_knet_tpu.models import rfp as jrfp
from video_knet_tpu.models.knet import KNet as JKNet
from video_knet_tpu.models.knet import panoptic_decode as jpanoptic_decode
from video_knet_tpu_torch import configs as tconfigs
from video_knet_tpu_torch.config import KNetConfig
from video_knet_tpu_torch.models import rfp
from video_knet_tpu_torch.models.backbones import build_backbone, build_neck
from video_knet_tpu_torch.models.knet import KNet, panoptic_decode
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.tools.train_check import draw_zero_init_leaves, relu_pattern
from video_knet_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.mark.parametrize("stride", [1, 2])
def test_saconv_matches_jax(stride):
    (x,) = seeded_inputs(1, (2, 11, 13, 8))
    jmod = jrfp.SAConv(features=12, stride=stride)
    port = rfp.SAConv(8, 12, stride)
    variables = shared_weights(port, jmod, jnp.asarray(x))
    want = jit_apply(jmod, variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(t(x))
    assert got.shape == (2, 6, 7, 12) if stride == 2 else (2, 11, 13, 12)
    assert_rel_close(got, want, FWD_TOL, f"SAConv stride {stride}")


@pytest.mark.parametrize("with_sac", [True, False])
def test_bottleneck_matches_jax(with_sac):
    x, r = seeded_inputs(2, (1, 10, 14, 64), (1, 5, 7, 24))
    jmod = jrfp.DetectoRSBottleneck(features=16, stride=2, with_sac=with_sac, with_rfp=True)
    port = rfp.DetectoRSBottleneck(64, 16, stride=2, with_sac=with_sac, with_rfp=True,
                                   rfp_channels=24)
    variables = shared_weights(port, jmod, jnp.asarray(x), jnp.asarray(r))
    want = jit_apply(jmod, variables, jnp.asarray(x), jnp.asarray(r))
    with torch.no_grad():
        got = port(t(x), t(r))
        without = port(t(x))
    assert_rel_close(got, want, FWD_TOL, f"bottleneck sac={with_sac}")
    assert not torch.equal(got, without)  # the RFP feature is seen


def _pyramid_inputs(seed: int, hw, strides=(4, 8, 16, 32), width=256):
    shapes = [(1, -(-hw[0] // s), -(-hw[1] // s), width) for s in strides]
    return seeded_inputs(seed, *shapes)


def test_detectors_resnet50_matches_jax():
    (x,) = seeded_inputs(3, (1, 32, 32, 3))
    feats = _pyramid_inputs(4, (32, 32))
    jargs = (jnp.asarray(x), [jnp.asarray(f) for f in feats])
    jmod = jrfp.DetectoRSResNet(depth=50)
    port = rfp.DetectoRSResNet(50)
    variables = shared_weights(port, jmod, *jargs)
    want = jit_apply(jmod, variables, *jargs)
    with torch.no_grad():
        got = port(t(x), [t(f) for f in feats])
    for s, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g, w, FWD_TOL, f"stage {s + 1}")


def _grads(port, jmod, variables, args, cot, relu_decisions=None):
    """(port grads, JAX grads) of sum(out * cot) w.r.t. every parameter and
    the inputs, both as flat flax-named numpy dicts."""
    def jloss(params, *xs):
        out = jmod.apply({**variables, "params": params}, *xs)
        return jnp.sum(out * cot)

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args) + 1))))(
        variables["params"], *[jnp.asarray(a) for a in args])
    want = {f"params/{'/'.join(k)}": np.asarray(v)
            for k, v in traverse_util.flatten_dict(flax.core.unfreeze(jg[0])).items()}
    xs = [t(a).requires_grad_(True) for a in args]
    pattern = list(relu_decisions or [])
    with relu_pattern(pattern, replay=True) as stats:
        out = port(*xs)
    assert stats["calls"] == len(pattern)
    (out * t(cot)).sum().backward()
    named = {n: p.grad for n, p in port.named_parameters()}
    got = state_dict_to_flax(port, named)
    for i, xi in enumerate(xs):
        got[f"input{i}"], want[f"input{i}"] = xi.grad.numpy(), np.asarray(jg[i + 1])
    return got, want


def test_saconv_gradients_match_jax():
    x, cot = seeded_inputs(8, (1, 9, 12, 8), (1, 5, 6, 8))
    jmod = jrfp.SAConv(features=8, stride=2)
    port = rfp.SAConv(8, 8, 2)
    variables = shared_weights(port, jmod, jnp.asarray(x))
    got, want = _grads(port, jmod, variables, (x,), cot)
    assert set(got) == set(want)
    for k in want:
        assert_rel_close(got[k], want[k], GRAD_TOL, k)


def test_sac_rfp_bottleneck_gradients_match_jax():
    """The port replays JAX's ReLU decisions (bn1, bn2, then the block's
    output: relu(z) > 0 exactly where z > 0)."""
    x, r, cot = seeded_inputs(9, (1, 10, 12, 32), (1, 5, 6, 16), (1, 5, 6, 32))
    jmod = jrfp.DetectoRSBottleneck(features=8, stride=2, with_sac=True, with_rfp=True)
    port = rfp.DetectoRSBottleneck(32, 8, stride=2, with_sac=True, with_rfp=True,
                                   rfp_channels=16)
    variables = shared_weights(port, jmod, jnp.asarray(x), jnp.asarray(r))
    out, state = jit_apply(jmod, variables, jnp.asarray(x), jnp.asarray(r),
                          capture_intermediates=lambda m, _: m.name in ("bn1", "bn2")
                          or m.parent is None)
    inter = state["intermediates"]
    decisions = [torch.from_numpy(np.asarray(v) > 0) for v in (
        inter["bn1"]["__call__"][0], inter["bn2"]["__call__"][0], out)]
    got, want = _grads(port, jmod, variables, (x, r), cot, decisions)
    assert set(got) == set(want)
    for k in want:
        assert_rel_close(got[k], want[k], GRAD_TOL, k)
    assert np.abs(got["params/rfp_conv/kernel"]).max() > 0
    assert np.abs(got["params/sac/weight_diff"]).max() > 0


def _rfp_check_cfg(base):
    return dataclasses.replace(train_check.image_check_cfg(base, deformable=False),
                               backbone="swin_t_rfp")


@pytest.fixture(scope="module")
def knet_swin_rfp():
    """The image KNet over `swin_t_rfp` at 64x96 in both packages, JAX's
    compiled once; the RFP's output and both calls of its backbone are
    captured on each side."""
    cfg = _rfp_check_cfg(KNetConfig())
    jcfg = _rfp_check_cfg(JKNetConfig())
    model = KNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert model.neck is None
    assert model.rpn_head.localization_fpn.l0_conv0.Conv_0.weight.shape[1] == 256
    draw_zero_init_leaves(model, torch.Generator().manual_seed(1))
    (img,) = seeded_inputs(10, (1, 64, 96, 3))
    jmodel = JKNet(jcfg)
    flat = state_dict_to_flax(model, model.state_dict())
    assert {k: v.shape for k, v in flat.items()} == jax_tree_shapes(jmodel, jnp.asarray(img))
    variables = perturb_norms(flax_tree(flat), 0)
    port_of(model, variables)
    (jrpn, jstages), state = jit_apply(
        jmodel, variables, jnp.asarray(img),
        capture_intermediates=lambda m, _: m.name in ("backbone", "bb"))
    inter = state["intermediates"]["backbone"]
    calls = {"bb": [], "backbone": []}
    hooks = [model.backbone.bb.register_forward_hook(
                 lambda m, a, out: calls["bb"].append(out)),
             model.backbone.register_forward_hook(
                 lambda m, a, out: calls["backbone"].append(out))]
    with torch.no_grad():
        rpn, stages = model(t(img))
        model.backbone.rfp_steps = 1
        first = model.backbone(t(img))
        model.backbone.rfp_steps = 2
    for h in hooks:
        h.remove()
    return dict(cfg=cfg, jcfg=jcfg, rpn=rpn, stages=stages, jrpn=jrpn, jstages=jstages,
                levels=calls["backbone"][0], jlevels=inter["__call__"][0], first=first,
                bb_calls=calls["bb"][:2], jbb_calls=inter["bb"]["__call__"])


def test_swin_rfp_backbone_matches_jax(knet_swin_rfp):
    """`SwinTransformerRFP('tiny')` at 64x96: its first call (no RFP input)
    and its second (the FPN levels fed back through `rfp_conv{s}`)."""
    r = knet_swin_rfp
    out0, out1 = r["bb_calls"]
    assert len(r["jbb_calls"]) == 2
    for call, (got, want) in enumerate(zip((out0, out1), r["jbb_calls"])):
        for s, (g, w) in enumerate(zip(got, want)):
            assert_rel_close(g, w, FWD_TOL, f"call {call} stage {s}")
    assert not torch.allclose(out0[3], out1[3])  # the RFP input is seen


def test_rfp_over_swin_tiny_matches_jax(knet_swin_rfp):
    """`RFP` over `swin_tiny_rfp`: both passes and the fusion."""
    r = knet_swin_rfp
    for i, (g, w) in enumerate(zip(r["levels"], r["jlevels"])):
        assert g.shape[-1] == 256
        assert_rel_close(g, w, FWD_TOL, f"level {i}")
        assert not torch.allclose(g, r["first"][i])  # the second pass and the fusion are seen


def test_image_knet_over_swin_rfp_matches_jax(knet_swin_rfp):
    r = knet_swin_rfp
    rpn, stages, jrpn, jstages = r["rpn"], r["stages"], r["jrpn"], r["jstages"]
    for name in ("mask_preds", "seg_preds", "x_feats", "proposal_feats"):
        assert_rel_close(getattr(rpn, name), getattr(jrpn, name), 1e-4, f"rpn {name}")
    for s, (g, w) in enumerate(zip(stages, jstages)):
        for name in ("cls_score", "mask_preds"):
            assert_rel_close(getattr(g, name), getattr(w, name), 1e-4, f"stage {s} {name}")
    jres = jpanoptic_decode(jrpn, jstages, r["jcfg"], out_hw=(64, 96)).result
    with torch.no_grad():
        res = panoptic_decode(rpn, stages, r["cfg"], out_hw=(64, 96)).result
    for name in ("panoptic_seg", "keep", "seg_ids", "labels", "isthing", "areas",
                 "instance_idx"):
        assert np.array_equal(np.asarray(getattr(res, name)),
                              np.asarray(getattr(jres, name))), name
    assert_rel_close(res.scores, jres.scores, 1e-4, "scores")


@pytest.mark.parametrize("name,count", [
    ("knet_s3_detectors_r50_cityscapes_step", 52_049_565),
    ("knet_s3_swin_b_rfp_cityscapes_step", 100_626_696),
])
def test_rfp_preset_parameter_tree_is_jax(name, count, monkeypatch):
    """Only the tree is read: the port's random init (8 s for 100M
    parameters on one thread) is skipped."""
    monkeypatch.setattr("video_knet_tpu_torch.models.knet.init_parameters", lambda *a: None)
    cfg = tconfigs.get_config(name)
    model = KNet(cfg, device="cpu")
    assert model.neck is None and build_neck(cfg.neck_type, model.backbone) is None
    flat = state_dict_to_flax(model, model.state_dict())
    want = jax_tree_shapes(JKNet(jconfigs.get_config(name)), jnp.zeros((1, 384, 1248, 3)))
    assert {k: v.shape for k, v in flat.items()} == want
    assert sum(int(np.prod(v.shape)) for k, v in flat.items() if k.startswith("params/")) == count
    assert isinstance(build_backbone(cfg.backbone), rfp.RFP)
