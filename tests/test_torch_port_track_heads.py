"""The other track heads against the JAX package, on the CPU: `query_fuse`
(`QueryTrackEmbed` and the match-score loss) and `roi_gt_box`
(`roi_track_head.ROITrackHead` over `ops/sampling.py:roi_align`, trained at
the GT masks' boxes, served at the predicted masks').

The tiny check config (`train_check.track_check_cfg`: the trained tiny
config's MiT-b0, 64-channel heads, 20 proposals, 4 GT slots) with each head,
weights made by the port from `train_check.margin_seed` and carried to flax
(the trees are held against JAX's init in `tests/test_torch_port_configs.py`),
on `train/vps.py:make_synthetic_batch(seed=0)`. JAX's value-and-grad with
its costs, assignments and ReLU inputs, and its test step on a linked frame,
are one jitted function a head; both are compiled in parallel threads with
optax's step and the device-tracker serving below. The port's ReLUs replay
JAX's decisions (`train_check.relu_pattern`).

Tolerances:
- the test step's outputs (last-stage logits and masks, track kernels and
  embeddings): 1e-5 relative;
- assignments equal; costs and losses 1e-4 relative; gradients each leaf
  within 1e-3 of its largest magnitude (an attention's key bias against its
  kernel's); one AdamW step fed JAX's gradients within 1e-5 of optax's.

Also: the trained tiny model with a seeded query head served on the device
tracker, whose state is `query_fc_out_channels` (1024) wide, in both
packages: integer maps bit-equal; `roi_align` (boxes across the edges, off
the map, empty, and boxes of GT masks) within 1e-5 of JAX's and its
gradient within 1e-5 of `jax.grad`'s; `masks_to_boxes` equal.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import trained_golden_common as jtg
from flax import traverse_util
from torch_port_common import assert_rel_close, jax_pre_relu, jax_relu_decisions, jax_step_costs

from video_knet_tpu.models.video import inference as jinf
from video_knet_tpu.models.video.roi_track_head import masks_to_boxes_jax
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu.models.video.knet_vps import video_knet_loss as jvideo_knet_loss
from video_knet_tpu.ops.targets import PanopticGT as JPanopticGT
from video_knet_tpu.ops.sampling import roi_align as jroi_align
from video_knet_tpu.train import optim as joptim
from video_knet_tpu_torch.models.knet import solve_lanes
from video_knet_tpu_torch.models.video import inference as tinf
from video_knet_tpu_torch.models.video.roi_track_head import masks_to_boxes
from video_knet_tpu_torch.models.video.knet_vps import (
    VideoKNet,
    video_knet_costs,
    video_knet_loss,
)
from video_knet_tpu_torch.ops.sampling import roi_align
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.utils.convert import (
    flatten_variables,
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
)

HW = (64, 96)
HEADS = ("query_fuse", "roi_gt_box")
BASE_LR = 1e-3
SERVE_FRAMES = 4
TEST_KEYS = ("cls", "masks", "track_obj_feats", "track_embeds", "new_obj_feats")


def _cfgs(head: str):
    pair = [train_check.track_check_cfg(c, head) for c in (jtg.tiny_cfg(), tg.tiny_cfg())]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    return pair


def _unflatten(flat: dict) -> dict:
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _test_outputs(out) -> dict:
    last = out["stage_outs"][-1]
    return dict(cls=last.cls_score, masks=last.mask_preds,
                **{k: out[k] for k in ("track_obj_feats", "track_embeds", "new_obj_feats")})


def _prepare(head: str) -> dict:
    """The port's model (margin-seed weights), its flax params, the batch and
    JAX's function of the step and the test step."""
    jcfg, cfg = _cfgs(head)
    seed, _ = train_check.margin_seed(cfg, HW)
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    params = _unflatten(state_dict_to_flax(model, model.state_dict()))["params"]
    batch = tvps.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    prev = np.random.RandomState(1).randn(
        1, cfg.num_proposals + cfg.num_stuff_classes, 1, cfg.head.in_channels).astype(np.float32)
    gt_masks = (batch.gt.masks.numpy(), batch.ref_gt.masks.numpy()) if head == "roi_gt_box" else ()
    jm, jtest = JVideoKNet(jcfg, train=True), JVideoKNet(jcfg, train=False)

    def jfn(p, img, ref_img, gt, ref_gt, prev, *gtm):
        def loss(p):
            (key, ref, ke, re), inter = jm.apply(
                {"params": p}, img, ref_img, *gtm, capture_intermediates=jax_pre_relu,
                mutable=["intermediates"])
            losses = jvideo_knet_loss((key, ref), (ke, re), gt, ref_gt, jcfg)
            return sum(losses.values()), (losses, key, ref, ke, re, inter["intermediates"])

        (_, (losses, key, ref, ke, re, inter)), grads = jax.value_and_grad(
            loss, has_aux=True)(p)
        costs, _, g2p, p2g = jax_step_costs(key, ref, gt, ref_gt, jcfg)
        test = jtest.apply({"params": p}, img, prev, jnp.asarray(False),
                           method=JVideoKNet.test_step)
        return dict(losses=losses, embeds=(ke, re), costs=costs, g2p=g2p, p2g=p2g, inter=inter,
                    grads=grads, test=_test_outputs(test))

    args = (params, batch.img.numpy(), batch.ref_img.numpy(),
            *(JPanopticGT(*(x.numpy() for x in g)) for g in (batch.gt, batch.ref_gt)), prev,
            *gt_masks)
    return dict(head=head, cfg=cfg, jcfg=jcfg, model=model, params=params, batch=batch,
                prev=prev, fn=jfn, args=args)


def _adamw(params, frozen_stages: int):
    tx = joptim.make_optimizer(params, 1000, base_lr=BASE_LR, warmup_iters=0,
                               frozen_stages=frozen_stages)
    return lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])


def _finish(prep: dict, want: dict) -> dict:
    """The port's step (replaying JAX's ReLU decisions) and test step on the
    same inputs."""
    model, batch, cfg = prep["model"], prep["batch"], prep["cfg"]
    gt_masks = ((batch.gt.masks, batch.ref_gt.masks) if prep["head"] == "roi_gt_box" else ())

    def fwd():
        return model.forward_train(batch.img, batch.ref_img, None, *gt_masks)

    with torch.no_grad():
        relus = jax_relu_decisions(want["inter"], model, fwd)
    with train_check.relu_pattern(relus, replay=True) as stats:
        key, ref, ke, re = fwd()
    assert stats["calls"] == len(relus) > 0
    losses = video_knet_loss((key, ref), (ke, re), batch.gt, batch.ref_gt, cfg)
    sum(losses.values()).backward()
    costs, valids = video_knet_costs(key, ref, batch.gt, batch.ref_gt, cfg)
    g2p, p2g = solve_lanes(costs, valids)
    with torch.no_grad():
        test = _test_outputs(model.test_step(batch.img, torch.from_numpy(prep["prev"]), False))
    return dict(prep, want=want, losses={k: float(v.detach()) for k, v in losses.items()},
                embeds=(ke.detach(), re.detach()), costs=torch.cat(costs).detach().numpy(),
                g2p=torch.cat(g2p).numpy(), p2g=torch.cat(p2g).numpy(), test=test,
                relu_calls=stats["calls"])


def _query_serving_models():
    """The trained tiny model with a seeded query head, in both packages."""
    jcfg, cfg = _cfgs("query_fuse")
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    head = {k: v for k, v in state_dict_to_flax(model, model.state_dict()).items()
            if k.startswith("params/track_embed/")}
    flat = {k: v for k, v in tg.load_weights().items() if not k.startswith("params/track_embed/")}
    flat.update(head)
    load_flax_variables(model, flat)
    return jcfg, cfg, model, _unflatten(flat)


def _jax_query_serving(jcfg, variables, frames):
    pipe = jinf.VPSInferencePipeline(JVideoKNet(jcfg, train=False), variables, jcfg,
                                     out_hw=tg.HW)
    assert pipe.device_tracker
    res = [pipe.run_frame(jnp.asarray(f), i == 0) for i, f in enumerate(frames)]
    return jtg.flatten_results(res), tuple(pipe.track_state.embeds.shape)


@functools.lru_cache(maxsize=None)
def _runs() -> dict:
    """Both heads, both AdamW steps and JAX's device-tracker serving; JAX's
    functions are traced one by one and compiled (or run) in parallel
    threads (XLA compiles outside the GIL)."""
    prep = {h: _prepare(h) for h in HEADS}
    jobs = {h: jax.jit(p["fn"]).lower(*p["args"]).compile for h, p in prep.items()}
    for h, p in prep.items():
        jobs[f"adamw_{h}"] = jax.jit(_adamw(p["params"], p["jcfg"].frozen_stages)).lower(
            p["params"], p["params"]).compile
    jcfg, cfg, model, variables = _query_serving_models()
    frames = tg.eval_frames()[:SERVE_FRAMES]
    jobs["serve"] = lambda: _jax_query_serving(jcfg, variables, frames)
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    runs = {h: _finish(p, done[h](*p["args"])) for h, p in prep.items()}
    for h in HEADS:
        runs[f"adamw_{h}"] = done[f"adamw_{h}"]
    runs["serve"] = dict(cfg=cfg, model=model, frames=frames, want=done["serve"])
    return runs


@pytest.fixture(scope="module", params=HEADS)
def setup(request):
    return _runs()[request.param]


def test_test_step_outputs_match_jax(setup):
    want, got = setup["want"]["test"], setup["test"]
    cfg = setup["cfg"]
    width = (cfg.track.query_fc_out_channels if setup["head"] == "query_fuse"
             else cfg.track.embed_channels)
    assert got["track_embeds"].shape == (1, cfg.num_proposals, width)
    for k in TEST_KEYS:
        assert_rel_close(got[k], want[k], 1e-5, f"{setup['head']} {k}")


def test_train_embeddings_match_jax(setup):
    """[B, N, 1024] query embeddings, or [B, G, D] GT-slot RoI embeddings."""
    cfg = setup["cfg"]
    rows = cfg.max_insts if setup["head"] == "roi_gt_box" else cfg.num_proposals
    for got, want, what in zip(setup["embeds"], setup["want"]["embeds"], ("key", "ref")):
        assert got.shape[:2] == (1, rows)
        assert_rel_close(got, want, 1e-4, f"{setup['head']} {what} embeds")


def test_assignments_and_costs_match_jax(setup):
    assert_rel_close(setup["costs"], setup["want"]["costs"], 1e-4, "stacked costs")
    np.testing.assert_array_equal(setup["g2p"], np.asarray(setup["want"]["g2p"]))
    np.testing.assert_array_equal(setup["p2g"], np.asarray(setup["want"]["p2g"]))


def test_losses_match_jax(setup):
    want = {k: float(v) for k, v in setup["want"]["losses"].items()}
    got = setup["losses"]
    assert set(got) == set(want)
    head_keys = {"query_fuse": {"loss_match"},
                 "roi_gt_box": {"loss_track_roi", "loss_track_roi_aux"}}[setup["head"]]
    assert head_keys <= set(got) and "loss_track" not in got
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def test_gradients_match_jax_leaf_by_leaf(setup):
    model = setup["model"]
    want = flatten_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                               setup["want"]["grads"])})
    got = state_dict_to_flax(model, {n: p.grad if p.grad is not None else torch.zeros_like(p)
                                     for n, p in model.named_parameters()})
    assert set(got) == set(want)
    head = "params/track_embed/" if setup["head"] == "query_fuse" else "params/roi_track_head/"
    assert any(k.startswith(head) and np.any(w) for k, w in want.items())
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if k.endswith("/key/bias"):  # zero up to rounding (tests/test_torch_port_train.py)
            scale = float(np.abs(want[k[:-len("bias")] + "kernel"]).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-3 * max(scale, 1e-12), (k, err, scale)


def test_one_adamw_step_matches_optax(setup):
    params = setup["params"]
    grads = jax.tree_util.tree_map(np.asarray, setup["want"]["grads"])
    want = flatten_variables({"params": _runs()[f"adamw_{setup['head']}"](grads, params)})
    model = VideoKNet(setup["cfg"], device="cpu")
    load_flax_variables(model, {"params": params})
    opt = toptim.make_optimizer(model, 1000, base_lr=BASE_LR, warmup_iters=0)
    jgrads = flax_to_state_dict({"params": grads})
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = jgrads[name].clone()
    opt.step()
    got = state_dict_to_flax(model, dict(model.named_parameters()))
    for k, w in want.items():
        assert float(np.abs(got[k] - w).max()) <= 1e-5 * max(float(np.abs(w).max()), 1e-12), k


def test_train_step_runs_each_head(setup):
    """`train_step` (the GT masks go into the forward for `roi_gt_box`):
    finite losses with the reference's keys, the step counted."""
    from video_knet_tpu_torch.train.train_state import create_train_state

    model = VideoKNet(setup["cfg"], generator=torch.Generator().manual_seed(3), device="cpu")
    state = create_train_state(model, toptim.make_optimizer(model, 1000, warmup_iters=0))
    state, losses = tvps.train_step(state, setup["batch"])
    assert state.step == 1
    assert set(losses) == set(setup["losses"]) | {"total_loss"}
    assert all(np.isfinite(float(v)) for v in losses.values())


def test_query_head_on_the_device_tracker_matches_jax():
    """The device tracker's state is 1024 wide (`_track_embed_dim`), and the
    trained tiny model with a seeded query head serves the same integer maps
    as JAX's on it."""
    s = _runs()["serve"]
    (want, jwidth) = s["want"]
    pipe = tinf.VPSInferencePipeline(s["model"], s["cfg"], tg.HW, device="cpu")
    assert pipe.device_tracker
    got = tg.flatten_results([pipe.run_frame(f, i == 0) for i, f in enumerate(s["frames"])])
    assert tuple(pipe.track_state.embeds.shape) == jwidth
    assert jwidth[1] == s["cfg"].track.query_fc_out_channels == 1024
    for k in want:
        if k.startswith("seg_score_"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any((got[f"trk_{i}"] > 0).any() for i in range(SERVE_FRAMES))


def _rois():
    """Boxes over a 12x20 map at spatial scale 0.5 (mask pixels): inside,
    across every edge, wholly off the map, empty (zeros, the empty mask's
    box) and degenerate (zero width)."""
    rng = np.random.RandomState(2)
    xy = rng.uniform(-6, 44, (12, 2))
    wh = rng.uniform(1, 20, (12, 2))
    inside = np.concatenate([xy, xy + wh], axis=1)
    edges = np.array([[-4, -4, 10, 10], [30, 18, 46, 30], [-3, 5, 45, 12], [0, 0, 40, 24],
                      [50, 30, 70, 40], [-20, -20, -6, -5], [0, 0, 0, 0], [7, 3, 7, 9]])
    return np.concatenate([inside, edges]).astype(np.float32)


def test_roi_align_and_its_gradient_match_jax():
    rng = np.random.RandomState(1)
    feat = rng.randn(12, 20, 8).astype(np.float32)
    rois = _rois()
    weight = rng.randn(len(rois), 7, 7, 8).astype(np.float32)
    jfn = jax.jit(lambda f, r: jroi_align(f, r, spatial_scale=0.5))
    want = np.asarray(jfn(feat, rois))
    f = torch.from_numpy(feat).requires_grad_()
    got = roi_align(f, torch.from_numpy(rois), spatial_scale=0.5)
    assert got.shape == (len(rois), 7, 7, 8)
    assert_rel_close(got.detach(), want, 1e-5, "roi_align")
    assert float(got.detach()[-4].abs().max()) == 0.0  # wholly off the map
    jgrad = jax.grad(lambda f: jnp.sum(jfn(f, rois) * weight))(feat)
    (got * torch.from_numpy(weight)).sum().backward()
    assert_rel_close(f.grad, np.asarray(jgrad), 1e-5, "roi_align gradient")


def test_masks_to_boxes_matches_jax():
    rng = np.random.RandomState(4)
    masks = (rng.rand(6, 16, 24) > 0.97).astype(np.float32)
    masks[1] = 0.0  # empty: a zero box
    masks[2] = 0.5  # not above 0.5: empty too
    masks[3, 4:9, 2:20] = 0.9
    want = np.asarray(masks_to_boxes_jax(jnp.asarray(masks)))
    np.testing.assert_array_equal(masks_to_boxes(torch.from_numpy(masks)).numpy(), want)
    assert not np.any(want[1:3])
