"""The port's train-step profiler against the JAX package's, on the CPU.

`scripts/profile_train.py` builds its parts inside `main()`, so the JAX side
here rebuilds them from the JAX package as that script writes them: the
backbone's proxy loss (`:122-131`), `video_knet_loss` at fixed model
outputs (`:149-152`) and `make_vps_loss_fn`'s value (`:114-117`). The
model is the trained tiny config (`torch_port_common._tiny_vps_cfg` of
`trained_golden.tiny_cfg()`: MiT-b0, 64-channel heads, 20 proposals) at
64x96 with the port's weights from `train_check.margin_seed`, carried to
flax with `utils/convert.py:state_dict_to_flax`, and
`make_synthetic_batch(seed=0)` in both packages.

Tolerances (fp32; `tests/test_torch_port_train.py` holds losses to 1e-4
and gradients to 1e-3 of each leaf's largest magnitude, and none here is
looser):
- the proxy backbone loss, the loss block's value and the forward loss:
  1e-4 relative;
- the proxy loss's parameter gradients: each leaf within 1e-4 of its
  largest magnitude, and exactly zero in both outside the backbone and
  neck;
- the loss block's gradients with respect to the outputs, both packages
  fed JAX's outputs: each leaf within 1e-4 of its largest magnitude, and
  the model's parameters take none.
The profiler's report (`profile(..., device="cpu", iters=1)`) holds every
key, finite positive times and the heads' estimate as the reference
reckons it; its FLOP and byte counters are held exactly on one matmul.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import trained_golden_common as jtg
from flax import traverse_util
from torch_port_common import _tiny_vps_cfg, assert_rel_close

from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu.models.video.knet_vps import video_knet_loss as jvideo_knet_loss
from video_knet_tpu.train import vps as jvps
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.tools import profile_train
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.train_check import margin_seed
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.train.optim import make_optimizer
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.utils.convert import state_dict_to_flax
from video_knet_tpu_torch.utils.tree import tree_map

HW = (64, 96)
TOL_LOSS = 1e-4
TOL_GRAD = 1e-4
NECK = ("params/backbone/", "params/neck/")


def _jax_parts(jcfg, variables, jb) -> dict:
    """JAX's three parts, jitted: the proxy loss's value and parameter
    gradients; the forward's outputs with `make_vps_loss_fn`'s value; the
    loss block's value and gradients at those outputs. The proxy loss
    compiles in a thread beside the other two (XLA compiles outside the
    GIL)."""
    jm = JVideoKNet(jcfg, train=True)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def bb_loss(p):  # scripts/profile_train.py:122-131, fp32
        both = jnp.concatenate([jb.ref_img, jb.img], axis=0)
        feats = jm.apply({"params": p, **rest}, both, method=JVideoKNet.extract_feat)
        return sum(jnp.mean(jnp.square(x.astype(jnp.float32))) for x in feats)

    def forward(p):  # the outputs (:141-146) and the forward loss (:114-117)
        outs = jm.apply({"params": p, **rest}, jb.img, jb.ref_img)
        return outs, jvps.make_vps_loss_fn(jm, jcfg)(p, rest.get("batch_stats", {}), jb)[0]

    def loss_on_outputs(o):  # :149-152
        key, ref, ke, re_ = o
        return sum(jvideo_knet_loss((key, ref), (ke, re_), jb.gt, jb.ref_gt, jcfg).values())

    out: dict = {}

    def run_bb():
        out["bb"] = jax.jit(jax.value_and_grad(bb_loss))(params)

    thread = threading.Thread(target=run_bb)
    thread.start()
    try:
        outs, out["fwd"] = jax.jit(forward)(params)
        out["outs"] = outs
        out["block"] = jax.jit(jax.value_and_grad(loss_on_outputs))(outs)
    finally:
        thread.join(timeout=600)
    assert not thread.is_alive() and "bb" in out
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = _tiny_vps_cfg(tg.tiny_cfg()), _tiny_vps_cfg(jtg.tiny_cfg())
    seed, _ = margin_seed(cfg, HW)
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    flat = state_dict_to_flax(model, model.state_dict())
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    jb = jvps.make_synthetic_batch(jcfg, 1, HW, seed=0)
    tb = tvps.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    return dict(cfg=cfg, model=model, tb=tb, want=_jax_parts(jcfg, variables, jb))


def _grads(model) -> dict:
    """{flax name: gradient} of every parameter, zero where it has none."""
    return state_dict_to_flax(model, {n: p.grad if p.grad is not None else torch.zeros_like(p)
                                      for n, p in model.named_parameters()})


def test_backbone_proxy_loss_and_gradients_match_jax(setup):
    model = setup["model"]
    model.zero_grad(set_to_none=True)
    loss = profile_train.backbone_loss(model, setup["tb"], False)
    loss.backward()
    value, grads = setup["want"]["bb"]
    assert_rel_close(loss.detach(), value, TOL_LOSS, "proxy loss")
    want = {"/".join(k): v for k, v in
            traverse_util.flatten_dict({"params": grads}).items()}
    got = _grads(model)
    model.zero_grad(set_to_none=True)
    assert set(got) == set(want)
    outside = [k for k in want if not k.startswith(NECK)]
    assert outside and any(k.startswith(NECK[1]) for k in want)
    for k, w in want.items():
        if k.startswith(NECK):
            assert np.any(w), k
            assert_rel_close(got[k], w, TOL_GRAD, k)
        else:
            assert not np.any(w) and not np.any(got[k]), k


def _pairs(got, want, path=""):
    """(path, port leaf, JAX leaf) of two output trees of one structure."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _pairs(g, w, f"{path}/{getattr(got, '_fields', range(len(got)))[i]}")
    else:
        yield path, got, want


def test_loss_block_at_fixed_outputs_matches_jax(setup):
    """Both packages' loss block at JAX's outputs: its value and its
    gradient with respect to every output; the model takes none."""
    model, tb, cfg, want = setup["model"], setup["tb"], setup["cfg"], setup["want"]
    with torch.no_grad():
        like = profile_train.model_outputs(model, tb, False)  # the port's output tree
    outs = tree_map(lambda p, j: None if p is None else torch.from_numpy(np.array(j)),
                    like, want["outs"])
    leaves = profile_train.output_leaves(outs)
    model.zero_grad(set_to_none=True)
    loss = profile_train.loss_block(leaves, tb, cfg)
    loss.backward()
    assert all(p.grad is None for p in model.parameters())
    value, grads = want["block"]
    assert_rel_close(loss.detach(), value, TOL_LOSS, "loss block")
    pairs = list(_pairs(leaves, grads))
    assert len(pairs) > 20
    for path, leaf, w in pairs:
        if leaf is None:
            assert w is None, path
            continue
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        if not np.any(w):
            assert not g.any(), path
        else:
            assert_rel_close(g, w, TOL_GRAD, path)
    assert sum(leaf is not None and leaf.grad is not None and bool(leaf.grad.any())
               for _, leaf, _ in pairs) >= 10


def test_forward_loss_matches_jax(setup):
    model = setup["model"]
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000))
    loss = profile_train.make_parts(state, setup["tb"])["fwd"]()
    assert not loss.requires_grad
    assert_rel_close(loss, setup["want"]["fwd"], TOL_LOSS, "forward loss")


def test_profile_report_on_the_cpu(setup):
    rep = profile_train.profile(setup["cfg"], HW, 1, iters=1, device="cpu")
    ms = [profile_train.MS_KEYS[p] for p in profile_train.PARTS]
    keys = {*ms, *(f"{k}_spread" for k in ms), "heads_fwd_bwd_ms_est", "hw", "batch", "device",
            "power_limit", "launches", "shares", "peak", "hbm", "counting", "bf16", "iters",
            *(f"{p}_{kind}" for p in profile_train.PARTS
              for kind in ("flops", "bytes", "compute_ms_ideal", "mem_ms_ideal"))}
    assert set(rep) == keys
    for k in ms:
        lo, hi = rep[f"{k}_spread"]
        assert 0 < lo <= rep[k] <= hi < float("inf"), k
    assert rep["heads_fwd_bwd_ms_est"] == (rep["full_ms"] - rep["backbone_fwd_bwd_ms"]
                                           - rep["loss_block_fwd_bwd_ms"])
    for p in profile_train.PARTS:
        assert rep[f"{p}_flops"] > 0 and rep[f"{p}_bytes"] > 0, p
    assert rep["full_flops"] > rep["backbone_flops"] > rep["loss_block_flops"]
    assert rep["full_compute_ms_ideal"] == rep["full_flops"] / 67e12 * 1e3
    assert rep["full_mem_ms_ideal"] == rep["full_bytes"] / 3.35e12 * 1e3
    # the CPU runs the kernels' plain versions: nothing launches
    assert rep["launches"] == {"mask_pool": 0, "assemble": 0, "hungarian": 0}
    assert (rep["device"], rep["power_limit"], rep["hw"], rep["batch"]) == ("cpu", None,
                                                                            list(HW), 1)


def test_counters_on_one_matmul():
    """m x k times k x n: 2mkn FLOPs; the inputs read and the output written
    once; a view moves nothing."""
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    assert profile_train.count(lambda: a @ b) == (2 * 3 * 5 * 7, 4 * (15 + 35 + 21))
    assert profile_train.count(lambda: (a.t(), a.view(15))) == (0, 0)


def test_defaults_are_the_scripts():
    args = profile_train.parse_args([])
    assert (args.hw, args.batch, args.bf16, args.device) == ([384, 1248], 1, False, None)
