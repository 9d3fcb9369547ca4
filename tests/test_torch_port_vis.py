"""The VIS slice as a whole against the JAX package, on the CPU: the clip
forward and the whole-clip decode (`models/vis/knet_vis.py`), the tube
losses and one train step (`train/vis.py`).

The tiny KNetVIS of `train_check.vis_check_cfg` (MiT-b0, 64-channel heads,
5 classes, 8 proposals, 4 tube slots, T=2, 64x96), in `frame` and `volume`
mode, weights made by the port from `train_check.vis_margin_seed` and
carried to flax (the trees are held against JAX's init in
`tests/test_torch_port_vis_heads.py`), on `train/vis.py:
make_synthetic_batch(seed=0)` (one tube is absent from a frame). JAX's
value-and-grad (frame mode) and its forward + loss (volume mode) are each
jitted once (compiled in parallel threads with optax's step), their
outputs and decode carried out as auxiliaries. The
port's ReLUs replay JAX's decisions (`train_check.relu_pattern`, from JAX's
captured ReLU inputs): an input within the packages' fp32 difference of
zero may pass in one and not the other, and such an element moves a
gradient behind it by up to ~0.2 of a leaf's scale at this size.

Tolerances, as `tests/test_torch_port_train.py` holds VPS:
- every forward output within 1e-4 relative; `vis_decode` at 64x96:
  labels, mask indices and track ids equal, scores within 1e-5, masks
  within 1e-4 relative;
- assignments: equal, every per-frame set ([B*T, N] each: the init head and
  3 stages) and every tube set ([B, N]: the 2 assigning clip stages; the
  init tubes in volume mode), all from the port's one solve;
- tube costs and losses: 1e-4 relative;
- gradients (frame mode): each leaf within 1e-3 of its largest magnitude
  (an attention's key bias against its kernel's, whose true gradient is
  zero);
- one AdamW step, fed JAX's gradients: within 1e-5 of optax's.
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
from flax import traverse_util
from torch_port_common import assert_rel_close, jax_pre_relu, jax_relu_decisions

import video_knet_tpu.ops.hungarian as jhung
from video_knet_tpu.config_vis import VISConfig as JVISConfig
from video_knet_tpu.models.kernel_iter_head import upscale_masks
from video_knet_tpu.models.knet import branch_assignment_costs as jbranch_costs
from video_knet_tpu.models.knet import solve_assignments as jsolve_assignments
from video_knet_tpu.models.vis import knet_vis as jvis
from video_knet_tpu.train import optim as joptim
from video_knet_tpu_torch.config_vis import VISConfig
from video_knet_tpu_torch.models.knet import solve_lanes
from video_knet_tpu_torch.models.vis import knet_vis as tvis
from video_knet_tpu_torch.ops import hungarian as thung
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train import vis as tv
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.utils.convert import (
    flatten_variables,
    flax_to_state_dict,
    state_dict_to_flax,
)

HW = (64, 96)
BASE_LR = 1e-3


def _cfgs(mode: str):
    pair = [dataclasses.replace(train_check.vis_check_cfg(c()), kernel_head_mode=mode)
            for c in (JVISConfig, VISConfig)]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    return pair


def _jax_costs(outs, gt, cfg):
    """JAX's cost matrices of a step, as `knet_vis_loss` builds them before
    its solves: the per-frame branch's sets (`branch_assignment_costs` on
    `frame_gt_from_clip`; volume: the init tubes' without cls), then the
    assigning clip stages' tube sets (`_tube_assign`'s dice + mask + focal
    cls, vmapped over the batch). Returns (costs, valids)."""
    a = cfg.assigner

    def tube(masks, cls):
        b, t, n = masks.shape[:3]
        pred = jnp.transpose(masks, (0, 2, 1, 3, 4)).reshape(b, n, -1)
        gm = gt.masks.reshape(b, gt.masks.shape[1], -1)

        def one(p, m, c, lab):
            cost = (jhung.dice_cost(p, m, weight=a.dice_weight)
                    + jhung.mask_cost(p, m, weight=a.mask_weight))
            return cost if c is None else cost + jhung.focal_cls_cost(c, lab, weight=a.cls_weight)

        if cls is None:
            return jax.vmap(lambda p, m, lab: one(p, m, None, lab))(pred, gm, gt.labels)
        return jax.vmap(one)(pred, gm, cls, gt.labels)

    if cfg.kernel_head_mode == "volume":
        tubes = outs.rpn_out.tube_mask_preds
        b, t, n = tubes.shape[:3]
        scaled = upscale_masks(tubes.reshape(b * t, n, *tubes.shape[-2:]),
                               cfg.rpn.feat_downsample_stride)
        costs, valids = [tube(scaled.reshape(b, t, n, *scaled.shape[-2:]), None)], [gt.valid]
    else:
        fgt = jvis.frame_gt_from_clip(gt)
        costs = list(jbranch_costs(outs.rpn_out, outs.frame_stage_outs, fgt, cfg))
        valids = [fgt.valid] * len(costs)
    for out in outs.clip_stage_outs[:cfg.tracker_assign_stages]:
        costs.append(tube(out.scaled_mask_preds, out.cls_score))
        valids.append(gt.valid)
    return costs, valids


def _jax_assignments(costs, valids):
    """JAX's own solve of each set (`pad_and_solve`, vmapped over the
    problems, as the loss solves them), in one jitted call."""
    sizes = np.cumsum([len(c) for c in costs])[:-1]
    g2p, _ = jax.jit(jax.vmap(jhung.pad_and_solve))(jnp.concatenate(costs),
                                                    jnp.concatenate(valids))
    return np.split(np.asarray(g2p), sizes)


def _prepare(mode: str) -> dict:
    """The port's model (margin-seed weights), its flax params, the batch,
    and JAX's loss function with its outputs, decode, costs and ReLU inputs
    as auxiliaries."""
    jcfg, cfg = _cfgs(mode)
    seed, _ = train_check.vis_margin_seed(cfg, HW)
    model = tvis.KNetVIS(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    flat = state_dict_to_flax(model, model.state_dict())
    params = traverse_util.unflatten_dict({tuple(k.split("/"))[1:]: v for k, v in flat.items()})
    batch = tv.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    jm = jvis.KNetVIS(jcfg, train=True)

    def jloss(p, clip, gt):
        outs, inter = jm.apply({"params": p}, clip, capture_intermediates=jax_pre_relu,
                               mutable=["intermediates"])
        losses = jvis.knet_vis_loss(outs, gt, jcfg)
        return sum(losses.values()), (outs, jvis.vis_decode(outs, jcfg, out_hw=HW), losses,
                                      _jax_costs(outs, gt, jcfg), inter["intermediates"])

    # frame mode: the value and gradient; volume mode: the loss and its
    # auxiliaries (no gradient)
    fn = jax.value_and_grad(jloss, has_aux=True) if mode == "frame" else jloss
    args = (params, batch.clip.numpy(), jvis.ClipGT(*(x.numpy() for x in batch.gt)))
    return dict(cfg=cfg, jcfg=jcfg, model=model, params=params, batch=batch, fn=fn, args=args)


def _adamw(params):
    """optax's AdamW step of the JAX trainer (warmup off), as (grads, params)
    -> new params."""
    tx = joptim.make_optimizer(params, 1000, base_lr=BASE_LR, warmup_iters=0,
                               frozen_stages=1)
    return lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])


def _finish(prep: dict, compiled) -> dict:
    """Run JAX's compiled function and the port on the same inputs."""
    cfg, model, batch = prep["cfg"], prep["model"], prep["batch"]
    if cfg.kernel_head_mode == "frame":
        (_, (want, jpred, losses, (costs, valids), inter)), grads = compiled(*prep["args"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
    else:
        _, (want, jpred, losses, (costs, valids), inter) = compiled(*prep["args"])
        grads = None
    assigns = _jax_assignments(costs, valids)

    # the port's ReLUs take JAX's decisions (`train_check.relu_pattern`)
    with torch.no_grad():
        relus = jax_relu_decisions(inter, model, lambda: model(batch.clip))
    with train_check.relu_pattern(relus, replay=True) as stats, torch.no_grad():
        pred = tvis.vis_decode(model(batch.clip), cfg, out_hw=HW)
    assert stats["calls"] == len(relus) > 0
    with train_check.relu_pattern(relus, replay=True):
        outs = model(batch.clip)
    tlosses = tvis.knet_vis_loss(outs, batch.gt, cfg)
    sum(tlosses.values()).backward()
    tcosts, tvalids = tvis.knet_vis_costs(outs, batch.gt, cfg)
    tassigns, _ = solve_lanes(tcosts, tvalids)
    return dict(
        prep, grads=grads, want=want, got=outs, jpred=jpred, pred=pred,
        losses={k: float(v) for k, v in losses.items()},
        tlosses={k: float(v.detach()) for k, v in tlosses.items()},
        assigns=assigns, tassigns=[a.numpy() for a in tassigns],
        costs=[np.asarray(c) for c in costs], tcosts=[c.detach().numpy() for c in tcosts])


@functools.lru_cache(maxsize=None)
def _runs() -> dict:
    """Both modes and the AdamW step. JAX's three functions are traced one
    by one and compiled in parallel threads (XLA compiles outside the GIL),
    the file's largest cost."""
    prep = {mode: _prepare(mode) for mode in ("frame", "volume")}
    lowered = {mode: jax.jit(p["fn"]).lower(*p["args"]) for mode, p in prep.items()}
    params = prep["frame"]["params"]
    lowered["adamw"] = jax.jit(_adamw(params)).lower(params, params)
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
    runs = {mode: _finish(p, compiled[mode]) for mode, p in prep.items()}
    runs["adamw"] = compiled["adamw"]
    return runs


@pytest.fixture(scope="module", params=["frame", "volume"])
def setup(request):
    return _runs()[request.param]


@pytest.fixture(scope="module")
def frame():
    return _runs()["frame"]


def _leaves(outs) -> dict:
    """Every array of a VISOutputs, by path."""
    flat = {}

    def walk(prefix, x):
        if x is None:
            return
        if isinstance(x, (tuple, list)):
            names = getattr(x, "_fields", None) or [str(i) for i in range(len(x))]
            for name, v in zip(names, x):
                walk(f"{prefix}/{name}", v)
        else:
            flat[prefix] = x

    walk("", outs)
    return flat


def test_knet_vis_outputs_match_jax(setup):
    want, got = _leaves(setup["want"]), _leaves(setup["got"])
    assert set(got) == set(want)
    mode = setup["cfg"].kernel_head_mode
    assert len(setup["got"].frame_stage_outs) == (3 if mode == "frame" else 0)
    for k, w in want.items():
        assert_rel_close(got[k], w, 1e-4, f"{mode} {k}")


def test_vis_decode_matches_jax(setup):
    cfg = setup["cfg"]
    pred, jpred = setup["pred"], setup["jpred"]
    k = cfg.test.max_per_img
    assert pred.masks.shape == (cfg.num_frames, k, *HW)
    for f in ("labels", "track_ids"):
        np.testing.assert_array_equal(getattr(pred, f).numpy(), np.asarray(getattr(jpred, f)), f)
    np.testing.assert_array_equal(pred.track_ids.numpy(), np.arange(k))
    assert_rel_close(pred.scores, jpred.scores, 1e-5, "scores")
    assert_rel_close(pred.masks, jpred.masks, 1e-4, "masks")
    # the mask index: each decoded tube is the last stage's mask of its proposal
    cls = setup["got"].clip_stage_outs[cfg.tracker_assign_stages - 1].cls_score[0]
    jcls = np.asarray(setup["want"].clip_stage_outs[cfg.tracker_assign_stages - 1]
                      .cls_score[0])
    idx = tvis.top_k(torch.sigmoid(cls).reshape(-1), k)[1] // cfg.num_classes
    jidx = np.asarray(jax.lax.top_k(jax.nn.sigmoid(jcls).reshape(-1), k)[1]) // cfg.num_classes
    np.testing.assert_array_equal(idx.numpy(), jidx)


def test_assignments_equal_jax(setup):
    """Every per-frame and tube assignment of the port's one solve."""
    got, want = setup["tassigns"], setup["assigns"]
    cfg = setup["cfg"]
    n_frame = 4 if cfg.kernel_head_mode == "frame" else 0  # the init head + 3 stages
    assert len(got) == len(want) == max(n_frame, 1) + cfg.tracker_assign_stages
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == ((2, 8) if i < n_frame else (1, 8)), (i, g.shape)
        np.testing.assert_array_equal(g, w, f"assignment set {i}")
    assert any((w >= 0).any() for w in want[n_frame:])  # the tubes match something


def test_costs_match_jax(setup):
    """Every cost set, the tube costs' N*T*H*W mask-cost area included."""
    assert len(setup["tcosts"]) == len(setup["costs"])
    for i, (g, w) in enumerate(zip(setup["tcosts"], setup["costs"])):
        assert g.shape == w.shape
        assert_rel_close(g, w, 1e-4, f"cost set {i}")


def test_losses_match_jax(setup):
    want, got = setup["losses"], setup["tlosses"]
    assert set(got) == set(want)
    assert "tracker_s2_loss_dice" in got and "tracker_s2_loss_cls" not in got
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def test_gradients_match_jax_leaf_by_leaf(frame):
    model = frame["model"]
    want = flatten_variables({"params": frame["grads"]})
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
    # the clip stages' mask branch reaches the loss through both kernels
    assert np.any(want["params/tracker/mask_head_0/fc_mask/kernel"])
    assert moved == len(want)


def test_one_adamw_step_matches_optax(frame):
    params, grads = frame["params"], frame["grads"]
    assert frame["jcfg"].frozen_stages == 1  # as `_adamw` builds optax's mask
    want = flatten_variables({"params": _runs()["adamw"](grads, params)})
    model = tvis.KNetVIS(frame["cfg"], device="cpu")
    sd = flax_to_state_dict({"params": params})
    model.load_state_dict(sd, strict=True)
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


def test_solve_lanes_takes_lanes_of_different_batch():
    """Sets of different leading sizes in one solve give what each set's own
    solve gives."""
    rng = np.random.RandomState(0)
    costs = [torch.from_numpy(rng.randn(b, 8, 4).astype(np.float32)) for b in (4, 1, 3, 1)]
    valids = [torch.from_numpy(rng.rand(b, 4) < 0.7) for b in (4, 1, 3, 1)]
    g2p, p2g = solve_lanes(costs, valids)
    for c, v, a, p in zip(costs, valids, g2p, p2g):
        want_a, want_p = thung.pad_and_solve(c, v)
        assert a.shape == (c.shape[0], 8) and p.shape == (c.shape[0], 4)
        assert torch.equal(a, want_a) and torch.equal(p, want_p)


def test_train_step_moves_the_weights(frame):
    """`train_step` on the CPU: finite losses with the reference's keys, the
    step counted, every parameter moved by AdamW."""
    model = tvis.KNetVIS(frame["cfg"], generator=torch.Generator().manual_seed(3), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, toptim.make_optimizer(model, 1000, warmup_iters=0))
    state, losses = tv.train_step(state, frame["batch"])
    assert state.step == 1
    assert set(losses) == set(frame["losses"]) | {"total_loss"}
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_unported_train_options_raise(frame):
    """`norm_eval=False` is ported; `bf16_train` with it raises JAX's
    ValueError; clip parallelism over the frames comes from the mesh, as
    JAX's step reads it (the `clip_parallel` keyword is gone), and a clip
    shorter than the mesh's `model` axis raises."""
    from video_knet_tpu_torch.parallel.mesh import DataMesh

    model, cfg = frame["model"], frame["cfg"]
    tv.make_vis_loss_fn(model, dataclasses.replace(cfg, norm_eval=False))
    with pytest.raises(ValueError, match="norm_eval=True"):
        tv.make_vis_loss_fn(model, dataclasses.replace(cfg, bf16_train=True, norm_eval=False))
    tv.make_vis_loss_fn(model, dataclasses.replace(cfg, bf16_train=True))  # ported
    state = create_train_state(model, toptim.make_optimizer(model, 1000))
    with pytest.raises(TypeError, match="clip_parallel"):
        tv.train_step(state, frame["batch"], clip_parallel=2)
    t = frame["batch"].clip.shape[1]
    state.mesh = DataMesh(0, t + 1, n_model=t + 1)
    with pytest.raises(ValueError, match=f"a clip of {t} frames does not split"):
        tv.train_step(state, frame["batch"])
