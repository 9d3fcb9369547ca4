"""The port's VPS train step against the JAX package's, on the CPU.

R-50 Video K-Net at 64x96 with max_insts=4 (the configuration of the JAX
package's own loss test, tests/test_coarse_assign.py), the same weights
(flax variables carried by `utils/convert.py`, norms perturbed) and the same
`make_synthetic_batch(seed=0)`; fine and coarse assignment costs.

Tolerances:
- assignments: equal. The Hungarian solve is also fed JAX's own cost
  matrices, where the numpy copy must give JAX's answer bit for bit.
- cost matrices and losses: 1e-4 relative (fp32 sums in another order).
- gradients: each leaf within 1e-3 of its largest magnitude (the backward
  sums in another order than XLA's, through three kernel-update stages).
  The port's forward replays JAX's ReLU decisions (`train_check.
  relu_pattern`, from `torch_port_common.jax_relu_decisions`, ResNet's
  included), so that a ReLU input within the forward error of zero cannot
  send the two backwards down different sides of its kink.
  One kind of leaf is looser: an attention's key bias, whose true gradient
  is zero (softmax ignores a shift shared by a query's logits), so both
  packages hold only rounding noise there; it is held within 1e-3 of the
  same projection's kernel gradient.
- one AdamW step, fed JAX's gradients: each parameter leaf within 1e-5 of its
  largest magnitude of optax's result (warmup off and lr 1e-3, so every
  parameter visibly moves).
"""

import dataclasses
import functools

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from torch_port_common import (
    assert_rel_close,
    jax_pre_relu,
    jax_relu_decisions,
    jax_step_costs,
    perturb_norms,
)

from video_knet_tpu import config as jc
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu.models.video.knet_vps import video_knet_loss as jvideo_knet_loss
from video_knet_tpu.train import optim as joptim
from video_knet_tpu.train import vps as jvps
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch.models.knet import solve_lanes
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet, video_knet_costs
from video_knet_tpu_torch.models.video.knet_vps import video_knet_loss
from video_knet_tpu_torch.ops.kernels.hungarian import hungarian_plain
from video_knet_tpu_torch.ops.targets import PanopticGT
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.utils.convert import (
    flatten_variables,
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
)

HW = (64, 96)
BASE_LR = 1e-3


def _cfgs(coarse: bool):
    pair = []
    for mod in (jc, tc):
        cfg = mod.VideoKNetConfig(max_insts=4)
        pair.append(dataclasses.replace(
            cfg, assigner=dataclasses.replace(cfg.assigner, coarse_costs=coarse)))
    return pair


@functools.lru_cache(maxsize=None)
def _setup(coarse: bool) -> dict:
    jcfg, tcfg = _cfgs(coarse)
    jm = JVideoKNet(jcfg, train=True)
    jb = jvps.make_synthetic_batch(jcfg, 1, HW, seed=0)
    variables = jm.init(jax.random.PRNGKey(0), jb.img, jb.ref_img)
    variables = perturb_norms(jax.tree_util.tree_map(np.asarray, variables), seed=1)

    def jloss(params, bs, batch):
        (key, ref, ke, re), inter = jm.apply(
            {"params": params, "batch_stats": bs}, batch.img, batch.ref_img,
            capture_intermediates=jax_pre_relu, mutable=["intermediates"])
        losses = jvideo_knet_loss((key, ref), (ke, re), batch.gt, batch.ref_gt, jcfg)
        return sum(losses.values()), (losses, key, ref, inter["intermediates"])

    (total, (losses, key, ref, inter)), grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(variables["params"],
                                                 variables["batch_stats"], jb)
    costs, valids, g2p, p2g = jax.jit(lambda k, r, b: jax_step_costs(k, r, b.gt, b.ref_gt, jcfg))(
        key, ref, jb)

    model = load_flax_variables(VideoKNet(tcfg, device="cpu"), variables)
    tb = tvps.make_synthetic_batch(tcfg, 1, HW, seed=0, device="cpu")
    # the port's ReLUs take JAX's decisions (`train_check.relu_pattern`)
    with torch.no_grad():
        relus = jax_relu_decisions(inter, model, lambda: model.forward_train(tb.img, tb.ref_img))
    with train_check.relu_pattern(relus, replay=True) as stats:
        tkey, tref, tke, tre = model.forward_train(tb.img, tb.ref_img)
    assert stats["calls"] == len(relus) > 0
    tlosses = video_knet_loss((tkey, tref), (tke, tre), tb.gt, tb.ref_gt, tcfg)
    sum(tlosses.values()).backward()
    tcosts, tvalids = video_knet_costs(tkey, tref, tb.gt, tb.ref_gt, tcfg)
    tg2p, tp2g = solve_lanes(tcosts, tvalids)
    return dict(
        jcfg=jcfg, tcfg=tcfg, variables=variables, jb=jb, tb=tb, model=model, key=key, tkey=tkey,
        total=float(total), losses={k: float(v) for k, v in losses.items()},
        grads=jax.tree_util.tree_map(np.asarray, grads),
        costs=np.asarray(costs), valids=np.asarray(valids), g2p=np.asarray(g2p),
        p2g=np.asarray(p2g), tlosses={k: float(v.detach()) for k, v in tlosses.items()},
        tcosts=torch.cat(tcosts).detach().numpy(), tg2p=torch.cat(tg2p).numpy(),
        tp2g=torch.cat(tp2g).numpy())


@pytest.fixture(scope="module", params=[False, True], ids=["fine", "coarse"])
def setup(request):
    """Both cost modes: the assignment, loss and gradient checks."""
    return _setup(request.param)


@pytest.fixture(scope="module")
def fine():
    """One cost mode for what does not depend on it (the optimizer, the
    weight conversion, the one-branch loss)."""
    return _setup(False)


def test_synthetic_batch_is_the_reference_batch(setup):
    jb, tb = setup["jb"], setup["tb"]
    np.testing.assert_array_equal(np.asarray(jb.img), tb.img.numpy())
    np.testing.assert_array_equal(np.asarray(jb.ref_img), tb.ref_img.numpy())
    for g_j, g_t in ((jb.gt, tb.gt), (jb.ref_gt, tb.ref_gt)):
        for f in PanopticGT._fields:
            np.testing.assert_array_equal(np.asarray(getattr(g_j, f)), getattr(g_t, f).numpy(), f)


def test_assignment_costs_match(setup):
    assert setup["tcosts"].shape == setup["costs"].shape == (10, 100, 4)
    assert_rel_close(setup["tcosts"], setup["costs"], 1e-4, "stacked costs")


def test_solver_on_jax_costs_is_bit_equal(setup):
    """JAX's own costs into the numpy solve: JAX's pred_of_gt exactly."""
    t = np.where(setup["valids"][:, :, None], setup["costs"].transpose(0, 2, 1), 0.0)
    p2g = np.where(setup["valids"], hungarian_plain(t.astype(np.float32)), -1)
    np.testing.assert_array_equal(p2g, setup["p2g"])


def test_assignments_equal_end_to_end(setup):
    np.testing.assert_array_equal(setup["tp2g"], setup["p2g"])
    np.testing.assert_array_equal(setup["tg2p"], setup["g2p"])


def test_losses_match(setup):
    want, got = setup["losses"], setup["tlosses"]
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    assert abs(sum(got.values()) - setup["total"]) <= 1e-4 * abs(setup["total"])


def test_gradients_match_leaf_by_leaf(setup):
    model = setup["model"]
    want = flatten_variables({"params": setup["grads"]})
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in model.named_parameters()}
    got = state_dict_to_flax(model, grads)
    assert set(got) == set(want)
    frozen = [k for k in want if k.startswith(("params/backbone/conv1", "params/backbone/bn1",
                                               "params/backbone/layer1_"))]
    assert frozen and all(not np.any(want[k]) and not np.any(got[k]) for k in frozen)
    moved = 0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if k.endswith("/key/bias"):  # zero up to rounding (see the module doc)
            scale = float(np.abs(want[k[:-len("bias")] + "kernel"]).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-3 * max(scale, 1e-12), (k, err, scale)
        moved += scale > 0
    # every trainable leaf is reached, through both mask kernels and the link
    assert moved == len(want) - len(frozen)


def test_one_adamw_step_matches_optax(fine):
    """The port's optimizer on JAX's gradients against optax's update."""
    variables, jcfg, tcfg = fine["variables"], fine["jcfg"], fine["tcfg"]
    params = variables["params"]
    tx = joptim.make_optimizer(params, 1000, base_lr=BASE_LR, warmup_iters=0,
                               frozen_stages=jcfg.frozen_stages)
    step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    want = flatten_variables({"params": step(fine["grads"], params)})

    model = load_flax_variables(VideoKNet(tcfg, device="cpu"), variables)
    opt = toptim.make_optimizer(model, 1000, base_lr=BASE_LR, warmup_iters=0)
    jgrads = flax_to_state_dict({"params": fine["grads"]})
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = jgrads[name].clone()
    opt.step()
    got = state_dict_to_flax(model, dict(model.named_parameters()))
    before = flatten_variables({"params": params})
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert float(np.abs(got[k] - w).max()) <= 1e-5 * max(scale, 1e-12), k
        if not k.startswith(("params/backbone/conv1", "params/backbone/bn1",
                             "params/backbone/layer1_")):
            assert np.any(w != before[k]), f"{k} did not move"


def test_schedule_matches_optax_schedule():
    for kw in (dict(), dict(warmup_iters=0), dict(decay_epochs=(1, 2))):
        j = joptim.make_lr_schedule(1e-4, 10, **kw)
        t = toptim.make_lr_schedule(1e-4, 10, **kw)
        for step in (0, 1, 5, 10, 15, 20, 999, 1000, 5000):
            assert abs(t(step) - float(j(step))) <= 1e-6 * float(j(step)), (kw, step)


def test_unported_train_options_raise():
    """`norm_eval=False` (live BatchNorm) is ported; `bf16_train` with it
    raises JAX's ValueError, `bf16_train` alone is ported, and a mesh whose
    `n_data * n_model` is not the world size raises (the `model` axis
    itself is ported: `tests/test_torch_port_model_axis.py`)."""
    from video_knet_tpu_torch.parallel.mesh import make_mesh

    model = VideoKNet(tc.VideoKNetConfig(max_insts=4), device="cpu")
    tvps.make_vps_loss_fn(model, dataclasses.replace(model.cfg, norm_eval=False))
    with pytest.raises(ValueError, match="norm_eval=True"):
        tvps.make_vps_loss_fn(model, dataclasses.replace(model.cfg, bf16_train=True,
                                                         norm_eval=False))
    tvps.make_vps_loss_fn(model, dataclasses.replace(model.cfg, bf16_train=True))
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(n_data=2, n_model=1)


def test_image_step_raises_for_live_bn_as_jax_does():
    """JAX's image step applies the model with `mutable=False`
    (tools/train_image.py:198-201), so flax cannot write live statistics
    and raises; the port's image step raises for `norm_eval=False` too,
    naming that reason."""
    import flax
    import jax.numpy as jnp

    from video_knet_tpu.models.knet import KNet as JKNet
    from video_knet_tpu_torch.models.knet import KNet
    from video_knet_tpu_torch.train import image as timage

    stage = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
    jcfg = dataclasses.replace(jc.KNetConfig(), norm_eval=False, **stage)
    jm = JKNet(jcfg, train=True)
    x = jnp.zeros((1, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    with pytest.raises(flax.errors.ModifyScopeVariableError):
        jax.eval_shape(lambda v: jm.apply(v, x, mutable=False), shapes)
    jax.eval_shape(lambda v: jm.apply(v, x, mutable=["batch_stats"]), shapes)  # live
    tcfg = dataclasses.replace(tc.KNetConfig(), norm_eval=False, **stage)
    with pytest.raises(NotImplementedError, match="mutable=False"):
        timage.make_image_loss_fn(KNet(tcfg, device="cpu"), tcfg)


def test_loss_fn_turns_tf32_off():
    """The train entry point holds cuBLAS and cuDNN to fp32, as serving
    does, whatever the caller had set."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        tvps.make_vps_loss_fn(VideoKNet(tc.VideoKNetConfig(max_insts=4), device="cpu"),
                              tc.VideoKNetConfig(max_insts=4))
        assert [f.allow_tf32 for f in flags] == [False, False]
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def test_frozen_mask_matches_jax(fine):
    """The parameters the port's ResNet freezes (`cfg.frozen_stages`) are
    the ones JAX's optimizer masks."""
    j = traverse_util.flatten_dict(
        joptim.frozen_mask(fine["variables"]["params"], fine["jcfg"].frozen_stages), sep="/")
    model = fine["model"]
    t = state_dict_to_flax(model, {n: p for n, p in model.named_parameters()})
    mask = toptim.frozen_mask(model)
    names = dict(zip(t, (mask[n] for n, _ in model.named_parameters())))
    assert {f"params/{k}": v for k, v in j.items()} == names


def test_state_dict_to_flax_round_trips(fine):
    """flax -> port -> flax is bit-equal for R-50 (BN statistics, MHA
    reshapes, Dense and conv transposes) and for the trained MiT-b0 model
    (grouped convs, its LayerNorms)."""
    from video_knet_tpu_torch.tools import trained_golden as tg

    model = fine["model"]
    want = flatten_variables(fine["variables"])
    got = state_dict_to_flax(model, model.state_dict())
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].tobytes() == w.astype(np.float32).tobytes(), k
    tiny = tg.tiny_model("cpu")
    want = {k: v.astype(np.float32) for k, v in tg.load_weights().items()}
    got = state_dict_to_flax(tiny, tiny.state_dict())
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k


def test_image_knet_loss_matches_jax(fine):
    """`knet_loss` (one branch: its own costs, one solve, init-head and stage
    losses) on the key branch's outputs of both packages."""
    from video_knet_tpu.models.knet import knet_loss as jknet_loss
    from video_knet_tpu_torch.models.knet import knet_loss

    key, tkey = fine["key"], fine["tkey"]
    want = jax.jit(lambda r, s, g: jknet_loss(r, s, g, fine["jcfg"]))(
        key.rpn_out, key.stage_outs, fine["jb"].gt)
    with torch.no_grad():
        got = knet_loss(tkey.rpn_out, tkey.stage_outs, fine["tb"].gt, fine["tcfg"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= 1e-4 * max(abs(float(w)), 1e-6), k
