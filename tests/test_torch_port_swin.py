"""The port's Swin backbone (`models/swin.py`) and the Swin slice as a whole,
against the JAX package, on the CPU.

Swin-tiny with perturbed norms; weights made by the port, carried to flax
by `utils/convert.py` (the tree is held against JAX's own init shapes):
- all four stage outputs within 1e-5 relative at 64x96 (stage 0 is 16x24,
  padded to 21x28, so the shifted blocks and their mask run there) and at
  52x76 (odd sizes into the patch merging);
- window partition / reverse, the shift mask and the relative-position
  index equal JAX's;
- stochastic depth: off without a generator, one keep draw a sample and the
  mean kept with one;
- the scan-stacked converter round trip.

The slice: Swin-tiny under the trained tiny model's 64-channel heads with
VIP-Seg's class split and the Swin KITTI-STEP link (`previous_link=
'update_dynamic_cov'`, `previous_type='update'`; `train_check.
swin_check_cfg`), weights from `train_check.margin_seed`:
- `VPSInferencePipeline` on 3 frames of 64x96, tracker on the device,
  against JAX's, with the norms perturbed so that things are kept and
  tracked: id, semantic and track maps and segments equal, scores within
  1e-4 relative;
- one train step at drop path 0 against JAX's `value_and_grad`, the port
  replaying JAX's ReLU decisions (`torch_port_common.jax_relu_decisions`):
  assignments equal, losses within 1e-4, gradients within 1e-3 of each
  leaf's scale;
  the backbone's (Swin-tiny at 64x96, `frozen_stages=1`) within 1e-4, and
  exactly zero, in both, where the reference's `stop_gradient` cuts (the
  patch embed and stage 0's patch merging; stage 0's blocks still reach
  the loss through their own output);
- one AdamW step within 1e-5 of optax's, which also decays those
  zero-gradient leaves.
- `train_step` without a generator draws the stochastic depth from one
  seeded with the step.
Each JAX function is compiled once (JAX's Swin forward is shared with
`test_torch_port_swin_import.py` through `torch_port_common`).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import trained_golden_common as jtg
from flax import traverse_util
from torch_port_common import (
    assert_rel_close,
    jax_pre_relu,
    jax_relu_decisions,
    jax_step_costs,
    jax_swin_tiny_apply,
    perturb_norms,
    port_of,
    t,
)

from video_knet_tpu.models import swin as jswin
from video_knet_tpu.models.video.inference import VPSInferencePipeline as JPipeline
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu.models.video.knet_vps import video_knet_loss as jvideo_knet_loss
from video_knet_tpu.train import optim as joptim
from video_knet_tpu.train import vps as jvps
from video_knet_tpu_torch.models import swin
from video_knet_tpu_torch.models.knet import solve_lanes
from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet, video_knet_costs
from video_knet_tpu_torch.models.video.knet_vps import video_knet_loss
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.trained_golden import flatten_results
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.utils.convert import (
    flatten_variables,
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
)

HW = (64, 96)
N_FRAMES = 3
BASE_LR = 1e-3
# where the reference's stop_gradient leaves no gradient at frozen_stages=1
CUT = ("patch_embed", "patch_norm", "downsample0")


def _flax_of(model: torch.nn.Module) -> dict:
    """The port's weights as nested flax variables."""
    flat = state_dict_to_flax(model, model.state_dict())
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _random_fill(model: torch.nn.Module, seed: int) -> None:
    """Seeded random weights, quicker than `layers.init_parameters`' truncated
    normals at Swin's size: kernels of unit fan-in variance, small biases
    and tables (the norms are perturbed after)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            scale = p[0].numel() ** -0.5 if p.dim() > 1 and p.shape[0] > 1 else 0.02
            p.copy_(torch.from_numpy((scale * rng.randn(*p.shape)).astype(np.float32)))


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def swin_tiny():
    """Port Swin-tiny and its flax variables, norms perturbed."""
    model = swin.SwinTransformer("tiny")
    _random_fill(model, 0)
    variables = perturb_norms(_flax_of(model), seed=1)
    assert _shapes(variables) == _shapes(jax.eval_shape(
        jswin.SwinTransformer("tiny").init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    return dict(model=port_of(model, variables), variables=variables)


@pytest.mark.parametrize("hw", [(64, 96), (52, 76)])
def test_swin_tiny_matches_jax(swin_tiny, hw):
    x = np.random.RandomState(0).randn(1, *hw, 3).astype(np.float32)
    want = jax_swin_tiny_apply()(swin_tiny["variables"], x)
    with torch.no_grad():
        got = swin_tiny["model"](t(x))
    assert len(got) == 4
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.shape[-1] == 96 * 2 ** s
        assert_rel_close(a, b, 1e-5, f"{hw} stage {s}")


@pytest.mark.parametrize("h,w,shift", [(21, 28, 3), (14, 14, 3), (28, 21, 2)])
def test_window_pieces_match_jax(h, w, shift):
    ws = 7
    x = np.random.RandomState(1).randn(2, h, w, 5).astype(np.float32)
    wins = swin.window_partition(t(x), ws)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jswin.window_partition(x, ws)))
    np.testing.assert_array_equal(swin.window_reverse(wins, ws, h, w).numpy(), x)
    np.testing.assert_array_equal(swin.shift_attn_mask(h, w, ws, shift).numpy(),
                                  np.asarray(jswin.shift_attn_mask(h, w, ws, shift)))
    np.testing.assert_array_equal(swin.relative_position_index(ws).numpy(),
                                  jswin.relative_position_index(ws))


def test_drop_path_is_per_sample_and_keeps_the_mean(swin_tiny):
    x = torch.ones(4096, 3, 5, 2)
    assert swin.drop_path(x, 0.3, None) is x
    y = swin.drop_path(x, 0.3, torch.Generator().manual_seed(0))
    per_sample = y.reshape(len(y), -1)
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)  # one draw a sample
    assert set(per_sample[:, 0].tolist()) == {0.0, float(torch.tensor(1.0) / 0.7)}
    assert abs(float(y.mean()) - 1.0) < 0.05  # ~5 standard errors of the mean
    # the backbone: eval (no generator) repeats; a generator's draws repeat by seed
    model = swin.SwinTransformer("tiny", drop_path_rate=0.5)
    model.load_state_dict(swin_tiny["model"].state_dict())
    img = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        e1, e2 = model(img)[-1], model(img)[-1]
        d1 = model(img, torch.Generator().manual_seed(2))[-1]
        d2 = model(img, torch.Generator().manual_seed(2))[-1]
        d3 = model(img, torch.Generator().manual_seed(3))[-1]
    assert torch.equal(e1, e2) and torch.equal(d1, d2)
    assert not torch.equal(d1, e1) and not torch.equal(d1, d3)


def test_scan_stacked_converter_round_trip(swin_tiny):
    """flax -> port -> flax is bit-equal: every `stage{s}_pairs` leaf is
    unstacked into `.{k}.` and restacked in pair order."""
    want = flatten_variables(swin_tiny["variables"])
    sd = flax_to_state_dict(swin_tiny["variables"])
    assert "stage2_pairs.2.blk1.attn.qkv.weight" in sd
    assert tuple(sd["stage2_pairs.2.blk1.attn.qkv.weight"].shape) == (3 * 384, 384)
    got = state_dict_to_flax(swin_tiny["model"], sd)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].tobytes() == w.astype(np.float32).tobytes(), k
    # a restack needs every pair
    del sd["stage2_pairs.1.blk0.norm1.bias"]
    with pytest.raises(KeyError):
        state_dict_to_flax(swin_tiny["model"], sd)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def slice_setup():
    cfg = train_check.swin_check_cfg(tg.tiny_cfg())
    jcfg = train_check.swin_check_cfg(jtg.tiny_cfg())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.RandomState(0)
    frames = [rng.randn(1, *HW, 3).astype(np.float32) for _ in range(N_FRAMES)]
    seed, _ = train_check.margin_seed(cfg, HW)
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    variables = _flax_of(model)
    return dict(cfg=cfg, jcfg=jcfg, model=model, variables=variables, frames=frames)


def test_slice_pipeline_matches_jax(slice_setup):
    """With the seed's norms perturbed: its own weights put one stuff segment
    over every 64x96 frame, these keep and track things."""
    s = slice_setup
    variables = perturb_norms(s["variables"], seed=2)
    model = load_flax_variables(s["model"], variables)
    jpipe = JPipeline(JVideoKNet(s["jcfg"], train=False), variables, s["jcfg"], HW,
                      thing_ids_in_orig=None)
    pipe = VPSInferencePipeline(model, s["cfg"], HW, thing_ids_in_orig=None, device="cpu")
    assert pipe.device_tracker and jpipe.device_tracker
    want = flatten_results([jpipe.run_frame(jnp.asarray(f), is_first=(i == 0))
                            for i, f in enumerate(s["frames"])])
    got = flatten_results([pipe.run_frame(f, is_first=(i == 0))
                           for i, f in enumerate(s["frames"])])
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("seg_score_"):
            assert_rel_close(got[k], w, 1e-4, k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert all(np.any(got[f"trk_{i}"] > 0) for i in range(N_FRAMES))


@pytest.fixture(scope="module")
def slice_train(slice_setup):
    """One train step's losses, assignments and gradients in both packages
    (drop path 0), the port's model holding its gradients."""
    s = slice_setup
    cfg, jcfg = s["cfg"], s["jcfg"]
    assert cfg.backbone_drop_path_rate == 0.0
    jm = JVideoKNet(jcfg, train=True)
    jb = jvps.make_synthetic_batch(jcfg, 1, HW, seed=0)

    def jloss(p, batch):
        (key, ref, ke, re), inter = jm.apply({"params": p}, batch.img, batch.ref_img,
                                             capture_intermediates=jax_pre_relu,
                                             mutable=["intermediates"])
        losses = jvideo_knet_loss((key, ref), (ke, re), batch.gt, batch.ref_gt, jcfg)
        return sum(losses.values()), (losses, jax_step_costs(key, ref, batch.gt,
                                                             batch.ref_gt, jcfg),
                                      inter["intermediates"])

    (_, (losses, (_, _, g2p, p2g), inter)), grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(s["variables"]["params"], jb)

    # the seed's own weights, for which the margin holds; drop path is off
    # without a generator
    model = load_flax_variables(s["model"], s["variables"])
    tb = tvps.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    # the port's ReLUs take JAX's decisions (`train_check.relu_pattern`)
    with torch.no_grad():
        relus = jax_relu_decisions(inter, model, lambda: model.forward_train(tb.img, tb.ref_img))
    with train_check.relu_pattern(relus, replay=True) as stats:
        key, ref, ke, re = model.forward_train(tb.img, tb.ref_img)
    assert stats["calls"] == len(relus) > 0
    tlosses = video_knet_loss((key, ref), (ke, re), tb.gt, tb.ref_gt, cfg)
    sum(tlosses.values()).backward()
    tg2p, tp2g = solve_lanes(*video_knet_costs(key, ref, tb.gt, tb.ref_gt, cfg))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return dict(
        jcfg=jcfg, model=model, grads=grads, want=flatten_variables({"params": grads}),
        got=state_dict_to_flax(model, {n: p.grad if p.grad is not None else torch.zeros_like(p)
                                       for n, p in model.named_parameters()}),
        losses={k: float(v) for k, v in losses.items()},
        tlosses={k: float(v.detach()) for k, v in tlosses.items()},
        assign=(np.asarray(g2p), np.asarray(p2g)),
        tassign=(torch.cat(tg2p).numpy(), torch.cat(tp2g).numpy()))


def test_slice_train_assignments_and_losses_match_jax(slice_train):
    for got, want in zip(slice_train["tassign"], slice_train["assign"]):
        np.testing.assert_array_equal(got, want)
    want, got = slice_train["losses"], slice_train["tlosses"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def test_swin_backbone_gradients_match_jax(slice_train):
    """The backbone's leaves of the step (Swin-tiny, 64x96, frozen_stages=1):
    within 1e-4 of each leaf's scale, and exactly zero, in both, where the
    reference's stop_gradient cuts."""
    want, got = slice_train["want"], slice_train["got"]
    backbone = [k for k in want if k.startswith("params/backbone/")]
    cut = {k for k in backbone if k.split("/")[2] in CUT}
    assert cut and {k for k in want if not np.any(want[k])} == cut
    assert all(p.requires_grad for p in slice_train["model"].backbone.parameters())
    for k in backbone:
        if k in cut:
            assert not np.any(got[k]), k
        else:
            assert_rel_close(got[k], want[k], 1e-4, k)


def test_slice_train_gradients_match_jax(slice_train):
    want, got = slice_train["want"], slice_train["got"]
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if k.endswith("/key/bias"):  # zero up to rounding (tests/test_torch_port_train.py)
            scale = float(np.abs(want[k[:-len("bias")] + "kernel"]).max())
        assert float(np.abs(got[k] - w).max()) <= 1e-3 * max(scale, 1e-12), k


def test_slice_adamw_step_matches_optax(slice_train, slice_setup):
    """One AdamW step on JAX's gradients: optax decays the zero-gradient Swin
    leaves too (its frozen mask knows only ResNet's names), and so does the
    port, whose Swin keeps `requires_grad` on."""
    params = slice_setup["variables"]["params"]
    grads, model = slice_train["grads"], slice_train["model"]
    tx = joptim.make_optimizer(params, 1000, base_lr=BASE_LR, warmup_iters=0,
                               frozen_stages=slice_train["jcfg"].frozen_stages)
    want = flatten_variables({"params": jax.jit(
        lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(grads, params)})
    opt = toptim.make_optimizer(model, 1000, base_lr=BASE_LR, warmup_iters=0)
    jgrads = flax_to_state_dict({"params": grads})
    for name, p in model.named_parameters():
        assert p.requires_grad, name
        p.grad = jgrads[name].clone()
    opt.step()
    got = state_dict_to_flax(model, dict(model.named_parameters()))
    before = flatten_variables({"params": params})
    grads_flat = slice_train["want"]
    for k, w in want.items():
        assert float(np.abs(got[k] - w).max()) <= 1e-5 * max(float(np.abs(w).max()), 1e-12), k
        if np.any(before[k]) or np.any(grads_flat[k]):  # weight decay moves the cut leaves
            assert np.any(w != before[k]), f"{k} did not move"


def test_train_step_draws_drop_path_seeded_with_the_step(slice_setup):
    """Without a generator, `train_step` draws the stochastic depth from one
    seeded with the step count (the reference folds the step into its key):
    equal to passing that generator, unlike another seed's."""
    cfg = dataclasses.replace(slice_setup["cfg"], backbone_drop_path_rate=0.3)
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = tvps.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    totals = []
    for gen in (None, torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)):
        m = copy.deepcopy(model)
        state = create_train_state(m, toptim.make_optimizer(m, 1000))
        state, losses = tvps.train_step(state, batch, gen)
        assert state.step == 1
        totals.append(float(losses["total_loss"]))
    assert totals[0] == totals[1] != totals[2], totals
