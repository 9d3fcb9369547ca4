"""The image slice against the JAX package, on the CPU: `KNet`
(`models/knet.py`) with either neck, its instance and panoptic decodes,
the sequential merges (`ops/panoptic.py`), the converter on KNet trees, and
one image train step (`train/image.py`).

The tiny image K-Net of `train_check.image_check_cfg` (MiT-b0, 64-channel
heads, 8 proposals, 4 GT slots, 64x96) in three variants: panoptic (3
thing + 2 stuff classes) and instance (the COCO instance form: 5 thing
classes, `num_stuff_classes=0`, `cat_stuff_mask=False`) with the
MSDeformAttn neck (its encoder cut to one layer: `train_check.shallow_neck`,
and JAX's decoder built at the same depth), and panoptic with the FPN.
Weights are made by the
port from `train_check.image_margin_seed` and carried to flax (the trees
are held against JAX's init below), on `train/image.py:
make_synthetic_batch(seed=0)`. Also a tiny deformable KNetVIS
(`train_check.vis_check_cfg` with the MSDeformAttn neck at one encoder
layer): its clip forward (the neck over the B*T frames) and `vis_decode`.
JAX's functions (forward + decode in every variant; + costs, assignments
and losses for the deformable ones; the value-and-grad for deformable
panoptic; the KNetVIS clip; optax's step) are jitted once each and
compiled in parallel threads. The port's ReLUs replay JAX's decisions
(`train_check.relu_pattern`), as `tests/test_torch_port_vis.py` does.

Tolerances (PERF.md section 2's gates, as the VPS and VIS steps are held):
- every forward output within 1e-4 relative;
- `panoptic_decode` at 64x96: the id map, keep, segment ids, labels,
  areas and the top-k thing indices equal, scores within 1e-5;
  `instance_decode`: labels equal, scores within 1e-5, masks within 1e-4;
- assignments equal (the init head and 3 stages), losses within 1e-4
  relative, gradients within 1e-3 of each leaf's largest magnitude, one
  AdamW step fed JAX's gradients within 1e-5 of optax's;
- the KNetVIS clip's outputs within 1e-4 relative, its decoded labels and
  track ids equal;
- the sequential merges: id maps and segments info equal.
"""

import copy
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from torch_port_common import (
    assert_rel_close,
    jax_pre_relu,
    jax_relu_decisions,
    jax_shallow_neck,
    port_of,
)

from video_knet_tpu.config import KNetConfig as JKNetConfig
from video_knet_tpu.config_vis import VISConfig as JVISConfig
from video_knet_tpu.models import knet as jknet
from video_knet_tpu.models import msdeform_decoder as jdec
from video_knet_tpu.models.vis import knet_vis as jvis
from video_knet_tpu.ops import panoptic as jpanoptic
from video_knet_tpu.ops.targets import PanopticGT as JPanopticGT
from video_knet_tpu.train import optim as joptim
from video_knet_tpu_torch.config import KNetConfig
from video_knet_tpu_torch.config_vis import VISConfig
from video_knet_tpu_torch.models import knet as tknet
from video_knet_tpu_torch.models.vis import knet_vis as tvis
from video_knet_tpu_torch.ops import panoptic as tpanoptic
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.train import image as ti
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train import vis as train_vis
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.utils.convert import (
    flatten_variables,
    flax_to_state_dict,
    state_dict_to_flax,
)

HW = (64, 96)
BASE_LR = 1e-3
# variant -> (instance, deformable, what JAX computes beyond forward + decode);
# instance with the FPN is the product of two variants' differences from
# pan-deform (the neck: pan-fpn; no stuff rows: inst-deform)
VARIANTS = {"pan-deform": (False, True, "grad"), "inst-deform": (True, True, "loss"),
            "pan-fpn": (False, False, None)}
LOSSY = [v for v, (_, _, extra) in VARIANTS.items() if extra]


def _cfgs(instance: bool, deformable: bool):
    pair = [train_check.image_check_cfg(c(), instance=instance, deformable=deformable)
            for c in (JKNetConfig, KNetConfig)]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    return pair


def _flax_params(model: torch.nn.Module) -> dict:
    flat = state_dict_to_flax(model, model.state_dict())
    return traverse_util.unflatten_dict({tuple(k.split("/"))[1:]: v for k, v in flat.items()})


def _jdecode(rpn_out, stage_outs, cfg, instance: bool):
    if instance:
        return jknet.instance_decode(rpn_out, stage_outs, cfg, out_hw=HW)
    return jknet.panoptic_decode(rpn_out, stage_outs, cfg, out_hw=HW)


def _tdecode(rpn_out, stage_outs, cfg, instance: bool):
    if instance:
        return tknet.instance_decode(rpn_out, stage_outs, cfg, out_hw=HW)
    return tknet.panoptic_decode(rpn_out, stage_outs, cfg, out_hw=HW)


def _prepare(variant: str) -> dict:
    """The port's model (margin-seed weights), its flax params, the batch
    and JAX's function of the variant, with its outputs, decode, costs,
    assignments, losses and ReLU inputs as auxiliaries."""
    instance, deformable, extra = VARIANTS[variant]
    jcfg, cfg = _cfgs(instance, deformable)
    seed, _ = train_check.image_margin_seed(cfg, HW)
    model = train_check.image_check_model(cfg, seed, "cpu")
    params = _flax_params(model)
    batch = ti.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    jm = jknet.KNet(jcfg)

    def jfn(p, img, gt):
        (rpn_out, stage_outs), inter = jm.apply(
            {"params": p}, img, capture_intermediates=jax_pre_relu, mutable=["intermediates"])
        aux = dict(outs=(rpn_out, stage_outs), pred=_jdecode(rpn_out, stage_outs, jcfg, instance),
                   inter=inter["intermediates"])
        if not extra:
            return aux
        costs = jknet.branch_assignment_costs(rpn_out, stage_outs, gt, jcfg)
        losses = jknet.knet_loss(rpn_out, stage_outs, gt, jcfg)
        aux.update(costs=costs, assigns=jknet.solve_assignments(costs, gt.valid)[0],
                   losses=losses)
        return sum(losses.values()), aux

    fn = jax.value_and_grad(jfn, has_aux=True) if extra == "grad" else jfn
    args = (params, batch.img.numpy(), JPanopticGT(*(x.numpy() for x in batch.gt)))
    return dict(variant=variant, instance=instance, extra=extra, cfg=cfg, jcfg=jcfg,
                model=model, params=params, batch=batch, fn=fn, args=args)


def _adamw(params):
    """optax's AdamW step of the JAX trainer (warmup off), as (grads, params)
    -> new params."""
    tx = joptim.make_optimizer(params, 1000, base_lr=BASE_LR, warmup_iters=0,
                               frozen_stages=1)
    return lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])


def _finish(prep: dict, compiled) -> dict:
    """Run JAX's compiled function and the port on the same inputs."""
    cfg, model, batch, instance = prep["cfg"], prep["model"], prep["batch"], prep["instance"]
    out = compiled(*prep["args"])
    grads = None
    if prep["extra"] == "grad":
        (_, aux), grads = out
        grads = jax.tree_util.tree_map(np.asarray, grads)
    elif prep["extra"] == "loss":
        _, aux = out
    else:
        aux = out
    with torch.no_grad():
        relus = jax_relu_decisions(aux["inter"], model, lambda: model(batch.img))
    with train_check.relu_pattern(relus, replay=True) as stats, torch.no_grad():
        pred = _tdecode(*model(batch.img), cfg, instance)
    assert stats["calls"] == len(relus) > 0
    run = dict(prep, grads=grads, want=aux["outs"], jpred=aux["pred"], pred=pred)
    if not prep["extra"]:
        return run
    with train_check.relu_pattern(relus, replay=True):
        rpn_out, stage_outs = model(batch.img)
    tlosses = tknet.knet_loss(rpn_out, stage_outs, batch.gt, cfg)
    if grads is not None:
        sum(tlosses.values()).backward()
    tcosts = tknet.branch_assignment_costs(rpn_out, stage_outs, batch.gt, cfg)
    tassigns, _ = tknet.solve_assignments(tcosts, batch.gt.valid)
    return dict(run, got=(rpn_out, stage_outs),
                losses={k: float(v) for k, v in aux["losses"].items()},
                tlosses={k: float(v.detach()) for k, v in tlosses.items()},
                assigns=[np.asarray(a) for a in aux["assigns"]],
                tassigns=[a.numpy() for a in tassigns],
                costs=[np.asarray(c) for c in aux["costs"]],
                tcosts=[c.detach().numpy() for c in tcosts])


def _vis_prepare() -> dict:
    """A tiny deformable KNetVIS (`train_check.vis_check_cfg` with the
    MSDeformAttn neck at one encoder layer), its clip, and JAX's forward +
    `vis_decode`."""
    jcfg, cfg = [dataclasses.replace(train_check.vis_check_cfg(c()),
                                     neck_type="msdeform_pixel_decoder")
                 for c in (JVISConfig, VISConfig)]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    model = train_check.shallow_neck(
        tvis.KNetVIS(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    batch = train_vis.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    jm = jvis.KNetVIS(jcfg)

    def fwd(params, clip):
        outs = jm.apply({"params": params}, clip)
        return outs, jvis.vis_decode(outs, jcfg, out_hw=HW)

    return dict(cfg=cfg, model=model, batch=batch, fn=fwd,
                args=(_flax_params(model), batch.clip.numpy()))


def _vis_finish(prep: dict, compiled) -> dict:
    want, jpred = compiled(*prep["args"])
    with torch.no_grad():
        got = prep["model"](prep["batch"].clip)
        pred = tvis.vis_decode(got, prep["cfg"], out_hw=HW)
    return dict(want=want, got=got, jpred=jpred, pred=pred)


@functools.lru_cache(maxsize=None)
def _runs() -> dict:
    """Every variant, the deformable KNetVIS clip and the AdamW step. JAX's
    functions are traced one by one (the deformable ones with JAX's decoder
    at the check depth), then compiled in parallel threads (XLA compiles
    outside the GIL)."""
    prep = {v: _prepare(v) for v in VARIANTS}
    prep["vis-deform"] = _vis_prepare()
    params = prep["pan-deform"]["params"]
    jfns = {k: (p["fn"], p["args"]) for k, p in prep.items()}
    jfns["adamw"] = (_adamw(params), (params, params))
    with jax_shallow_neck():
        lowered = {k: jax.jit(fn).lower(*args) for k, (fn, args) in jfns.items()}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
    runs = {v: _finish(prep[v], compiled[v]) for v in VARIANTS}
    runs["vis-deform"] = _vis_finish(prep["vis-deform"], compiled["vis-deform"])
    runs["adamw"] = compiled["adamw"]
    return runs


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    return _runs()[request.param]


@pytest.fixture(scope="module", params=LOSSY)
def lossy(request):
    return _runs()[request.param]


@pytest.fixture(scope="module")
def train():
    return _runs()["pan-deform"]


def _leaves(outs) -> dict:
    flat = {}

    def walk(prefix, x):
        if isinstance(x, (tuple, list)):
            names = getattr(x, "_fields", None) or [str(i) for i in range(len(x))]
            for name, v in zip(names, x):
                walk(f"{prefix}/{name}", v)
        elif x is not None:
            flat[prefix] = x

    walk("", outs)
    return flat


# ---------------------------------------------------------------- the model


def test_knet_outputs_match_jax(setup):
    with torch.no_grad():
        got = _leaves(setup["model"](setup["batch"].img))
    want = _leaves(setup["want"])
    assert set(got) == set(want)
    n_tot = setup["cfg"].num_proposals + setup["cfg"].num_stuff_classes
    assert got["/1/2/cls_score"].shape == (1, n_tot, 5)
    for k, w in want.items():
        assert_rel_close(got[k], w, 1e-4, f"{setup['variant']} {k}")


def test_decode_matches_jax(setup):
    pred, jpred = setup["pred"], setup["jpred"]
    if setup["instance"]:
        assert pred.masks.shape == (setup["cfg"].test.max_per_img, *HW)
        np.testing.assert_array_equal(pred.labels.numpy(), np.asarray(jpred.labels))
        assert_rel_close(pred.scores, jpred.scores, 1e-5, "scores")
        assert_rel_close(pred.masks, jpred.masks, 1e-4, "masks")
        return
    res, jres = pred.result, jpred.result
    assert res.panoptic_seg.shape == HW
    for f in ("panoptic_seg", "keep", "seg_ids", "labels", "isthing", "areas", "instance_idx"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f)), f)
    np.testing.assert_array_equal(pred.thing_mask_idx.numpy(), np.asarray(jpred.thing_mask_idx))
    assert_rel_close(res.scores, jres.scores, 1e-5, "scores")
    nt = setup["cfg"].num_thing_classes
    info = tpanoptic.segments_to_host(res, nt)[1]
    jinfo = jpanoptic.segments_to_host(jax.tree_util.tree_map(np.asarray, jres), nt)[1]
    assert [{k: v for k, v in i.items() if k != "score"} for i in info] == [
        {k: v for k, v in i.items() if k != "score"} for i in jinfo]
    assert int(res.keep.sum()) > 0


def test_assignments_equal_jax(lossy):
    got, want = lossy["tassigns"], lossy["assigns"]
    assert len(got) == len(want) == 4  # the init head and 3 stages
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, f"assignment set {i}")
    assert all((w >= 0).any() for w in want)
    for i, (g, w) in enumerate(zip(lossy["tcosts"], lossy["costs"])):
        assert_rel_close(g, w, 1e-4, f"cost set {i}")


def test_losses_match_jax(lossy):
    want, got = lossy["losses"], lossy["tlosses"]
    assert set(got) == set(want)
    assert {"loss_rpn_seg", "s2_loss_rank"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def test_gradients_match_jax_leaf_by_leaf(train):
    model = train["model"]
    want = flatten_variables({"params": train["grads"]})
    got = state_dict_to_flax(model, {n: p.grad if p.grad is not None else torch.zeros_like(p)
                                     for n, p in model.named_parameters()})
    assert set(got) == set(want)
    moved = 0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if k.endswith("/key/bias"):  # zero up to rounding (tests/test_torch_port_train.py)
            scale = float(np.abs(want[k[:-len("bias")] + "kernel"]).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-3 * max(scale, 1e-12), (k, err, scale)
        moved += scale > 0
    # the deformable neck's sampling offsets and level embeddings take gradients
    assert np.any(want["params/neck/layer0/self_attn/sampling_offsets/kernel"])
    assert np.any(want["params/neck/level_embed2"])
    assert moved == len(want)


def test_one_adamw_step_matches_optax(train):
    params, grads = train["params"], train["grads"]
    assert train["jcfg"].frozen_stages == 1  # as `_adamw` builds optax's mask
    want = flatten_variables({"params": _runs()["adamw"](grads, params)})
    model = copy.deepcopy(train["model"])
    model.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    opt = toptim.make_optimizer(model, 1000, base_lr=BASE_LR, warmup_iters=0)
    jgrads = flax_to_state_dict({"params": grads})
    for name, p in model.named_parameters():
        p.grad = jgrads[name].clone()
    opt.step()
    got = state_dict_to_flax(model, dict(model.named_parameters()))
    before = flatten_variables({"params": params})
    for k, w in want.items():
        assert float(np.abs(got[k] - w).max()) <= 1e-5 * max(float(np.abs(w).max()), 1e-12), k
        assert np.any(w != before[k]), f"{k} did not move"


def test_train_step_is_the_loss_fn_step(train):
    """`train/image.py:train_step` takes `make_image_loss_fn`'s losses, with
    the reference's keys, and moves every parameter."""
    model = copy.deepcopy(train["model"])
    model.zero_grad(set_to_none=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, toptim.make_optimizer(model, 1000, warmup_iters=0))
    state, losses = ti.train_step(state, train["batch"])
    assert state.step == 1
    assert set(losses) == set(train["losses"]) | {"total_loss"}
    # the first forward ran on the same weights and inputs, without the replay
    assert abs(float(losses["total_loss"]) - sum(train["losses"].values())) <= 1e-4 * abs(
        float(losses["total_loss"]))
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_deformable_knet_vis_forward():
    """The tiny deformable KNetVIS: the neck over the clip's B*T frames."""
    r = _runs()["vis-deform"]
    want, got = r["want"], r["got"]
    assert_rel_close(got.rpn_out.mask_preds, want.rpn_out.mask_preds, 1e-4, "init masks")
    for s, (g, w) in enumerate(zip(got.frame_stage_outs, want.frame_stage_outs)):
        assert_rel_close(g.cls_score, w.cls_score, 1e-4, f"frame stage {s} cls")
        assert_rel_close(g.mask_preds, w.mask_preds, 1e-4, f"frame stage {s} masks")
    for s, (g, w) in enumerate(zip(got.clip_stage_outs, want.clip_stage_outs)):
        assert_rel_close(g.mask_preds, w.mask_preds, 1e-4, f"clip stage {s} masks")


def test_deformable_knet_vis_decode():
    r = _runs()["vis-deform"]
    for f in ("labels", "track_ids"):
        np.testing.assert_array_equal(getattr(r["pred"], f).numpy(),
                                      np.asarray(getattr(r["jpred"], f)))
    assert_rel_close(r["pred"].masks, r["jpred"].masks, 1e-4, "decoded masks")


# ---------------------------------------------------------------- converter


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(tree).items()}


@functools.lru_cache(maxsize=None)
def _jax_tree(deformable: bool) -> dict:
    """Leaf shapes of JAX's KNet init (`jax.eval_shape`): the FPN model's
    whole tree; for the deformable one, the same tree with its `neck`
    subtree from the init of JAX's decoder on MiT-b0's levels (the rest of
    the model sees the same 256-wide levels), traced at one encoder layer
    whose leaves repeat for each of the default decoder's layers (one
    module class, the same inputs)."""
    jcfg, _ = _cfgs(instance=False, deformable=False)
    init = jax.eval_shape(jknet.KNet(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    shapes = _shapes(init)
    if not deformable:
        return shapes
    feats = [jnp.zeros((1, HW[0] // s, HW[1] // s, c))
             for s, c in zip((4, 8, 16, 32), (32, 64, 160, 256))]
    neck = _shapes(jax.eval_shape(jdec.MSDeformAttnPixelDecoder(num_layers=1).init,
                                  jax.random.PRNGKey(0), feats))
    layers = jdec.MSDeformAttnPixelDecoder().num_layers
    shapes = {k: v for k, v in shapes.items() if k[1] != "neck"}
    for k, v in neck.items():
        for i in range(layers) if k[1] == "layer0" else [None]:
            path = k[1:] if i is None else (f"layer{i}", *k[2:])
            shapes[(k[0], "neck", *path)] = v
    return shapes


@pytest.mark.parametrize("deformable", [False, True], ids=["fpn", "deformable"])
def test_convert_knet_tree_strict_and_round_trip(deformable):
    """The port's tree is JAX's init tree (the full 6-layer decoder), leaf
    for leaf and shape for shape; loading is strict; the round trip is
    bit-equal."""
    _, cfg = _cfgs(instance=False, deformable=deformable)
    model = tknet.KNet(cfg, device="cpu")
    flat = state_dict_to_flax(model, model.state_dict())
    assert {tuple(k.split("/")): v.shape for k, v in flat.items()} == _jax_tree(deformable)
    assert {k.split("/")[1] for k in flat} == {"backbone", "neck", "rpn_head", "roi_head"}
    if deformable:
        assert {"params/neck/level_embed2", "params/neck/input_proj0/kernel",
                "params/neck/layer5/self_attn/value_proj2/kernel",
                "params/neck/layer5/self_attn/sampling_offsets/bias",
                "params/neck/layer0/self_attn/attention_weights/kernel",
                "params/neck/layer0/self_attn/output_proj/kernel",
                "params/neck/layer3/ffn2/kernel", "params/neck/layer3/norm2/scale",
                "params/neck/lateral0/kernel", "params/neck/fuse0/GroupNorm_0/scale"} <= set(flat)
        # flax's initializers: zero offsets, unit-normal level embeddings
        assert not model.neck.layer0.self_attn.sampling_offsets.weight.any()
        assert 0.5 < float(model.neck.level_embed0.detach().std()) < 1.5
    rng = np.random.RandomState(6)
    variables = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
    port_of(model, variables)
    back = state_dict_to_flax(model, model.state_dict())
    assert set(back) == set(variables)
    for k, v in variables.items():
        assert back[k].tobytes() == v.tobytes(), k
    with pytest.raises(KeyError):
        port_of(model, {k: v for k, v in variables.items() if "/neck/" not in k})


# ------------------------------------------------------ sequential merges


def _merge_inputs(seed: int):
    """Seeded boolean masks with heavy overlaps, tied scores and repeated
    stuff labels."""
    rng = np.random.RandomState(seed)
    h, w = 40, 56
    k, s = 12, 6
    things = np.zeros((k, h, w), bool)
    for i in range(k):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        things[i, y:y + rng.randint(4, 24), x:x + rng.randint(4, 30)] = True
    things[3] = things[2]  # a duplicate, dropped by the overlap rule
    scores = rng.choice([0.1, 0.3, 0.5, 0.7, 0.9], size=k).astype(np.float32)
    stuff = rng.rand(s, h, w) > 0.93
    stuff_labels = rng.choice([5, 6, 7], size=s).astype(np.int32)
    stuff_scores = rng.rand(s).astype(np.float32)
    labels = rng.randint(0, 5, size=k).astype(np.int32)
    return things, labels, scores, stuff, stuff_labels, stuff_scores


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("merge", ["merge_sequential_host", "merge_sequential_host_stuff_first"])
def test_sequential_merge_matches_jax(merge, seed):
    args = _merge_inputs(seed)
    kw = dict(instance_score_thr=0.25, iou_thr=0.5, stuff_max_area=40)
    got_pan, got_info = getattr(tpanoptic, merge)(*args, **kw)
    want_pan, want_info = getattr(jpanoptic, merge)(*args, **kw)
    np.testing.assert_array_equal(got_pan, want_pan)
    assert got_info == want_info
    assert {i["isthing"] for i in want_info} == {True, False}
