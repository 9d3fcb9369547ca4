"""The port's utilities and training options against the JAX package's, on
the CPU: the visualizer (bit-equal), the precision casts (the same dtype a
leaf), `--freeze-detector`'s trainable set (JAX's `frozen_mask` leaf for
leaf), the preemption guard, the benchmark and trace harness, the bf16
kernel boundary and `promote_like_jax`, the Cityscapes-STEP tree writer
and each new CLI's refusal to run on a box without a GPU.
"""

import dataclasses
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_port_common  # noqa: F401  (one torch thread)
import trained_golden_common as jtg
from flax import traverse_util

import video_knet_tpu.utils.precision as jprec
import video_knet_tpu.utils.visualizer as jvis
from video_knet_tpu.train import optim as joptim
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.ops.kernels import mask_ops as mo
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step
from video_knet_tpu_torch.utils import precision as tprec
from video_knet_tpu_torch.utils import preemption, profiling
from video_knet_tpu_torch.utils import visualizer as tvis
from video_knet_tpu_torch.utils.convert import flax_names, state_dict_to_flax

# ------------------------------------------------------------------ visualizer


def test_visualizer_matches_jax():
    rng = np.random.RandomState(0)
    track = rng.choice([0, 1, 7, 300, 70000, 1234567], size=(24, 40))
    cat = rng.randint(0, 25, size=(24, 40)).astype(np.int64)
    cat[0, :5] = 255
    img = rng.randint(0, 256, size=(24, 40, 3)).astype(np.uint8)
    boxes = np.array([[2, 3, 20, 15], [-5, 10, 60, 30], [30.7, 1.2, 38.9, 22.5]])
    for i in (0, 1, 255, 65536, -3):
        assert tvis.id2rgb(i) == jvis.id2rgb(i)
    np.testing.assert_array_equal(tvis.CITYSCAPES_PALETTE, jvis.CITYSCAPES_PALETTE)
    pairs = [
        (tvis.trackmap2rgb(track), jvis.trackmap2rgb(track)),
        (tvis.cat2rgb(cat), jvis.cat2rgb(cat)),
        (tvis.overlay(img, tvis.trackmap2rgb(track), 0.3),
         jvis.overlay(img, jvis.trackmap2rgb(track), 0.3)),
        (tvis.draw_boxes(img, boxes), jvis.draw_boxes(img, boxes)),
        (tvis.draw_boxes(img, boxes, ids=np.array([5, 0, 300]), thickness=3),
         jvis.draw_boxes(img, boxes, ids=np.array([5, 0, 300]), thickness=3)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ precision


def _variants():
    """The trained tiny config and its track-head / link variants: every
    track key of JAX's `frozen_mask` has a leaf in one of them."""
    base, jbase = tg.tiny_cfg(), jtg.tiny_cfg()
    link = dict(previous_link="update_dynamic_cov", previous_type="update")
    return {"kernel_embed": (base, jbase),
            "link_update": (dataclasses.replace(base, **link), dataclasses.replace(jbase, **link)),
            "query_fuse": (dataclasses.replace(base, track_head_type="query_fuse"),
                           dataclasses.replace(jbase, track_head_type="query_fuse"))}


@pytest.fixture(scope="module")
def models():
    return {k: VideoKNet(t, generator=torch.Generator().manual_seed(0), device="cpu")
            for k, (t, _) in _variants().items()}


def _flax_tree(model) -> dict:
    return traverse_util.unflatten_dict(state_dict_to_flax(model, model.state_dict()), sep="/")


@pytest.mark.parametrize("keep", [True, False])
def test_cast_params_makes_jax_dtype_decisions(models, keep):
    """`cast_params` and `cast_variables` give every leaf the dtype JAX's
    give it (`keep_norms_fp32` keeps every `scale` and `bias` leaf fp32, a
    Dense bias too), and keep the fp32 masters."""
    model = models["link_update"]
    tree = _flax_tree(model)
    want = traverse_util.flatten_dict(
        jprec.cast_variables(tree, keep_norms_fp32=keep), sep="/")
    cast = tprec.cast_variables(model, keep_norms_fp32=keep)
    flax = flax_names(model, cast)
    assert set(flax.values()) == set(want), set(want) ^ set(flax.values())
    for k, v in cast.items():
        assert v.dtype == (torch.float32 if want[flax[k]].dtype == np.float32
                           else torch.bfloat16), k
    params = tprec.cast_params(model, keep_norms_fp32=keep)
    jparams = traverse_util.flatten_dict(jprec.cast_params(tree["params"],
                                                           keep_norms_fp32=keep), sep="/")
    pflax = flax_names(model, params)
    assert set(pflax.values()) == {f"params/{k}" for k in jparams}
    kept = {k for k, v in params.items() if v.dtype == torch.float32}
    assert kept == {k for k in params if jparams[pflax[k][len("params/"):]].dtype == np.float32}
    assert (len(kept) > 0) == keep
    assert all(p.dtype == torch.float32 for p in model.parameters())  # masters untouched


def test_cast_decisions_are_made_once_a_model(models, monkeypatch):
    """`cast_params` / `cast_variables` look the flax names up once a model
    and reuse them: later casts give the same dtypes without a lookup."""
    import copy

    import video_knet_tpu_torch.utils.convert as convert

    model = copy.deepcopy(models["link_update"])  # a model the casts have not seen
    lookups = []
    names = convert.flax_names
    monkeypatch.setattr(convert, "flax_names", lambda *a, **k: lookups.append(1) or names(*a, **k))
    for keep in (False, True):
        first = {k: v.dtype for k, v in tprec.cast_variables(model, keep_norms_fp32=keep).items()}
        n = len(lookups)
        assert n > 0
        for _ in range(2):
            again = tprec.cast_variables(model, keep_norms_fp32=keep)
            assert {k: v.dtype for k, v in again.items()} == first
            tprec.cast_params(model, keep_norms_fp32=keep)
        assert len(lookups) == n


def test_layer_dtypes_records_the_backbone_and_neck(models):
    """`layer_dtypes`: one entry a convolution or dense layer of the
    backbone and neck that ran, with its output dtype (fp32 in an fp32
    forward, bf16 in `bf16_forward`); its hooks are gone on exit."""
    model = models["kernel_embed"]
    batch = make_synthetic_batch(model.cfg, 1, (64, 96), device="cpu")
    with torch.no_grad():
        with tprec.layer_dtypes(model) as fp32:
            model.forward_train(batch.img, batch.ref_img)
        with tprec.layer_dtypes(model) as bf16:
            tprec.bf16_forward(model, "forward_train", batch.img.bfloat16(),
                               batch.ref_img.bfloat16())
    assert fp32 and set(fp32) == set(bf16)
    assert {p.split(".")[0] for p in fp32} == {"backbone", "neck"}
    assert all(d == {torch.float32} for d in fp32.values())
    assert all(d == {torch.bfloat16} for d in bf16.values())
    assert not any(m._forward_hooks for m in model.modules())


def test_bf16_kernel_boundary_is_exact():
    """K1 and K2 on bf16 inputs: fp32 results, bit-equal to the fp32 calls
    on the upcast inputs (a bf16 value and a product of two are exact in
    fp32)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 9, 6, 10, generator=g).bfloat16()
    feats = torch.randn(2, 6, 10, 24, generator=g).bfloat16()
    kern = torch.randn(2, 9, 24, generator=g).bfloat16()
    pooled = mo.fused_mask_pool(logits, feats)
    assert pooled.dtype == torch.float32
    assert torch.equal(pooled, mo.fused_mask_pool(logits.float(), feats.float()))
    for sig in (False, True):
        out = mo.fused_assemble(kern, feats, sigmoid=sig)
        assert out.dtype == torch.float32
        assert torch.equal(out, mo.fused_assemble(kern.float(), feats.float(), sigmoid=sig))


def test_promote_like_jax():
    """Inside the mode a matmul, convolution or norm of bf16 and fp32
    inputs runs in fp32 (jnp's promotion), equal to the call on upcast
    inputs; same-dtype calls are left alone; outside, PyTorch raises."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 8, generator=g)
    w = torch.randn(5, 8, generator=g).bfloat16()
    with pytest.raises(RuntimeError):
        F.linear(x, w)
    with tprec.promote_like_jax():
        y = F.linear(x, w)
        z = F.linear(x.bfloat16(), w)
        m = x @ w.T
    assert y.dtype == m.dtype == torch.float32 and z.dtype == torch.bfloat16
    assert torch.equal(y, F.linear(x, w.float()))
    assert torch.equal(m, x @ w.float().T)


def test_bf16_forward_keeps_fp32_masters_and_gradients(models):
    """`bf16_forward` of the tiny model: fp32 outputs within bf16's reach of
    the fp32 forward, the module's own tensors untouched, fp32 gradients."""
    model = models["kernel_embed"]
    batch = make_synthetic_batch(model.cfg, 1, (64, 96), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    key16 = tprec.bf16_forward(model, "forward_train", batch.img.bfloat16(),
                               batch.ref_img.bfloat16())[0]
    with torch.no_grad():
        key32 = model.forward_train(batch.img, batch.ref_img)[0]
    # the init head and the first stage, before hard mask decisions compound
    for got, want in ((key16.rpn_out.mask_preds.detach(), key32.rpn_out.mask_preds),
                      (key16.stage_outs[0].mask_preds.detach(), key32.stage_outs[0].mask_preds)):
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) < 0.05 * float(want.abs().max())
    masks16 = key16.stage_outs[-1].mask_preds
    masks16.float().sum().backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(gr.dtype == torch.float32 for gr in grads)
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    model.zero_grad(set_to_none=True)


# ------------------------------------------------------------------ freeze_detector


@pytest.mark.parametrize("variant", ["kernel_embed", "link_update", "query_fuse"])
def test_freeze_detector_trainable_set_matches_jax(models, variant):
    """`frozen_mask(freeze_detector=True)` equals JAX's leaf for leaf (with
    the tracking keys under the port's own module names), and without it the
    backbone stem and layer1 freeze as JAX's mask does."""
    model = models[variant]
    names = flax_names(model, dict(model.named_parameters()))
    params = _flax_tree(model)["params"]
    for freeze in (True, False):
        want = traverse_util.flatten_dict(
            joptim.frozen_mask(params, frozen_stages=model.cfg.frozen_stages,
                               freeze_detector=freeze), sep="/")
        got = toptim.frozen_mask(model, freeze_detector=freeze)
        assert {names[k][len("params/"):]: v for k, v in got.items()} == want
    trainable = {names[k] for k, v in toptim.frozen_mask(model, True).items() if v}
    keys = {"kernel_embed": ("track_embed", "attention_previous", "link_ffn"),
            "link_update": ("link_update", "track_update"),
            "query_fuse": ("track_embed",)}[variant]
    assert all(any(k in n for n in trainable) for k in keys), trainable


def test_freeze_detector_leaves_the_detector_still():
    """A step under `make_optimizer(freeze_detector=True)`: the detector
    takes no gradient and stays bit-equal, every track / link parameter
    moves, and the optimizer holds state for those alone."""
    cfg = tg.tiny_cfg()
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = toptim.make_optimizer(model, 10, warmup_iters=0, freeze_detector=True)
    trainable = {k for k, v in toptim.frozen_mask(model, True).items() if v}
    state, _ = train_step(create_train_state(model, opt),
                          make_synthetic_batch(cfg, 1, (64, 96), device="cpu"))
    for k, p in model.named_parameters():
        if k in trainable:
            assert not torch.equal(p, before[k]), k
        else:
            assert p.grad is None and not p.requires_grad and torch.equal(p, before[k]), k
    held = {id(p) for g in opt.adamw.param_groups for p in g["params"]}
    assert held == {id(p) for k, p in model.named_parameters() if k in trainable}
    assert set(map(id, opt.adamw.state)) == held


# ------------------------------------------------------------------ preemption, profiling


def test_preemption_guard_flags_then_exits():
    """SIGTERM sets the flag (the loop finishes the step), a second signal
    exits with 128 + signum, `restore` puts the old handler back."""
    old = signal.getsignal(signal.SIGTERM)
    guard = preemption.PreemptionGuard()
    try:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
        with pytest.raises(SystemExit) as e:
            os.kill(os.getpid(), signal.SIGTERM)
        assert e.value.code == 128 + signal.SIGTERM
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGTERM) is old


def test_preemption_guard_is_silent_off_the_main_thread():
    made = []
    t = threading.Thread(target=lambda: made.append(preemption.PreemptionGuard()))
    t.start()
    t.join()
    assert not made[0].requested and made[0]._prev == {}
    made[0].restore()


def test_benchmark_and_trace(tmp_path):
    """`benchmark` times the first call apart and counts its calls;
    `trace` writes a Chrome trace naming the ops it saw;
    `device_memory_stats` is empty without a GPU."""
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": (x @ x,)}

    x = torch.randn(32, 32)
    res = profiling.benchmark(fn, x, warmup=3, iters=7)
    assert len(calls) == 1 + 2 + 7 and res.iters == 7
    assert 0 < res.p50_s <= res.p99_s and res.mean_s > 0 and res.compile_s > 0
    assert res.per_sec == pytest.approx(1 / res.mean_s)
    with profiling.trace(str(tmp_path / "tr")):
        fn(x)
    with open(tmp_path / "tr" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


# ------------------------------------------------------------------ data, CLIs


def test_cityscapes_step_tree_reads_in_both_packages(tmp_path):
    """`write_cityscapes_step_tree`'s images and GT, as both packages'
    `CityscapesSTEPImages` scan them: the same samples, decoding to the
    arrays written."""
    from video_knet_tpu.data.datasets import CityscapesSTEPImages as J
    from video_knet_tpu_torch.data.datasets import CityscapesSTEPImages as T
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.tools.data_check import write_cityscapes_step_tree

    written = write_cityscapes_step_tree(str(tmp_path), n_images=2, hw=(32, 64))
    got, want = T(str(tmp_path)).samples, J(str(tmp_path)).samples
    assert len(got) == 4 and [(s.img, s.ann) for s in got] == [(s.img, s.ann) for s in want]
    for s in got:
        np.testing.assert_array_equal(load_png(s.img), written[s.img])
        np.testing.assert_array_equal(load_png(s.ann), written[s.ann])


def test_loader_skip_epochs_gives_the_unbroken_order():
    """`skip_epochs(n)` leaves the loader's draws where n iterated epochs
    leave them."""
    from video_knet_tpu_torch.data.loader import ThreadedLoader

    class Draws(ThreadedLoader):
        ds = range(7)

    a = Draws(seed=3, prefetch=1, num_threads=1, process_index=0, process_count=1,
              device="cpu")
    b = Draws(seed=3, prefetch=1, num_threads=1, process_index=0, process_count=1,
              device="cpu")
    for _ in range(2):
        a._epoch_draws()
    b.skip_epochs(2)
    for x, y in zip(a._epoch_draws(), b._epoch_draws()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cli,argv", [
    ("train_vps", ["--data-root", "nowhere"]),
    ("train_vis", ["--ann-file", "nowhere.json"]),
    ("train_image", ["--data-root", "nowhere"]),
    ("get_flops", ["--shape", "64", "96"]),
])
def test_new_cli_without_device_raises_on_a_box_without_a_gpu(cli, argv):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mod = importlib.import_module(f"video_knet_tpu_torch.tools.{cli}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
