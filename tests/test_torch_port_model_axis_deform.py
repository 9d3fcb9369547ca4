"""The MSDeformAttn pixel decoder on the bands of the mesh's `model` axis
(`models/msdeform_decoder.py` under `parallel/model_axis.py`'s band split),
against the JAX package and against the port in one process.

On a band the decoder's queries are the band's tokens of the three encoder
levels, with the whole level's positional code and reference points at the
band's global rows; each encoder layer projects the band's value maps and
gathers them whole (`model_axis.whole_maps`), since a query samples
anywhere. The sampling offsets are drawn to reach a few pixels
(`train_check.spread_sampling_offsets`): at their init (zero) every query
samples its own pixel, and no band would read another's rows.

Against JAX: the port's one-stage R-50 VPS step with the decoder (cut to
one encoder layer on both sides, `train_check.shallow_neck`) over 2 gloo
ranks on a 1x2 mesh against JAX's `make_sharded_train_step` on 2 virtual
CPU devices at 128x96 (4 stride-32 rows: bands of 64 + 64, two stride-32
rows each). JAX's sharded step agrees there with its unsharded one (held
below: losses within LOSS_REL, gradients within GRAD_REL), so the port is
held to the sharded step; the ranks replay the unsharded step's ReLU
decisions and mask-pool binarizations, which it takes once an input (the
sharded step can decide an input within its rounding of 0 on a band's
edge rows both ways: `tests/test_torch_port_model_axis_swin.py`). The
losses within LOSS_REL, the gradient within GRAD_REL of each leaf's
largest magnitude, the parameters after the step within STATS_REL.

Against the port in one process (`tools/dp_check.py:pyramid_share`, each
case's ranks in processes of their own, at nice 19 beside the JAX jobs):
ResNet-50 + decoder (six encoder layers) at 72x96 over 2 (64 + 8 rows: the
last band holds one row at strides 8, 16 and 32) and Swin-tiny + decoder at
120x96 over 2 (64 + 56), replaying the whole forward's ReLU decisions: each
rank's band of each level within LEVEL_REL of the level's largest
magnitude, the image's and the parameters' gradients summed over the ranks
within HALO_GRAD_REL, the gather bytes as `dp_check.decoder_gather_bytes`
reckons them. Also: the band's reference points and positional code at 376
rows equal the whole level's rows bit for bit, and the sampling core takes
fewer queries than values.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch
from torch_port_common import (
    _collect,
    _send_spec,
    _spawn,
    jax_relu_decisions,
    perturbed_variables,
    rel_err,
    relu_call_order,
    weight_of,
)

import video_knet_tpu.config as jconfig
import video_knet_tpu_torch.config as tconfig
from video_knet_tpu_torch.models import msdeform_decoder
from video_knet_tpu_torch.models.backbones import backbone_and_neck, build_backbone, build_neck
from video_knet_tpu_torch.models.layers import (
    band_positional_encoding,
    init_parameters,
    sine_positional_encoding,
)
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.ops.sampling import ms_deform_attn_core
from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools.train_check import (
    NECK_LAYERS,
    relu_pattern,
    shallow_neck,
    spread_sampling_offsets,
)
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.utils.convert import load_flax_variables, state_dict_to_flax

JAX_HW = (128, 96)  # 4 stride-32 rows: bands of 64 + 64
ONE_STAGE = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
DECODER = dict(max_insts=4, neck_type="msdeform_pixel_decoder", **ONE_STAGE)
# tests/test_torch_port_model_axis.py's tolerances against JAX's sharded step
LOSS_REL = 5e-4
STATS_REL = 1e-4
GRAD_REL = 1e-3
# the band split against the whole forward, in the port
LEVEL_REL, HALO_GRAD_REL = 1e-5, 1e-4
PYRAMIDS = {"resnet50_72x96_over_2": ("resnet50", 2, (72, 96)),
            "swin_tiny_120x96_over_2": ("swin_tiny", 2, (120, 96))}
REACH = 2.0  # the sampling offsets' spread (their biases), in pixels of each level
NICE = 19  # the port's processes yield the cores to the JAX jobs while these compile


def _pyramid(name: str, seed: int = 0):
    """A seeded backbone + decoder in eval mode, ResNet's statistics off
    their init, the offsets reaching a few pixels."""
    gen = torch.Generator().manual_seed(seed)
    backbone = build_backbone(name)
    neck = build_neck("msdeform_pixel_decoder", backbone)
    init_parameters(backbone, gen)
    init_parameters(neck, gen)
    spread_sampling_offsets(neck, torch.Generator().manual_seed(seed), REACH)
    with torch.no_grad():
        for key, buf in backbone.named_buffers():
            if key.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
            elif key.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=gen)
    return backbone.eval(), neck.eval()


def _pyramid_case(name: str, n_model: int, hw) -> tuple[dict, dict]:
    """(the band split's spec, the whole forward and backward here, whose
    ReLU decisions the bands replay)."""
    backbone, neck = _pyramid(name)
    rng = np.random.RandomState(n_model + hw[0])
    img = torch.from_numpy(rng.randn(1, *hw, 3).astype(np.float32))
    x = img.clone().requires_grad_(True)
    relus: list = []
    with relu_pattern(relus):
        levels = backbone_and_neck(backbone, neck, x)
    cot = [torch.from_numpy(rng.randn(*lv.shape).astype(np.float32)) for lv in levels]
    sum((lv * c).sum() for lv, c in zip(levels, cot)).backward()
    grads = {f"{tag}.{n}": p.grad.clone() for tag, m in (("backbone", backbone), ("neck", neck))
             for n, p in m.named_parameters() if p.grad is not None}
    whole = dict(levels=[lv.detach() for lv in levels], grad_img=x.grad, grads=grads)
    spec = dict(kind="pyramid", n_model=n_model, backbone=name, neck="msdeform_pixel_decoder",
                img=img, cotangents=cot, weights=(backbone.state_dict(), neck.state_dict()),
                relus=relus)
    return spec, whole


@pytest.fixture(scope="module", autouse=True)
def jax_jobs(tmp_path_factory):
    """JAX's sharded step and its unsharded one, started with the file:
    they import (and later trace and compile, the longest work here) while
    the tests that need no run go first; then `runs` sends their specs."""
    root = str(tmp_path_factory.mktemp("model_axis_deform"))
    jobs = {tag: _spawn(root, f"deform_{tag}", None, nice=0, devices=devices)
            for tag, devices in (("sharded", 2), ("whole", 1))}
    yield root, jobs
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(jax_jobs):
    """JAX's two steps in processes of their own, then the port's ranks
    replaying the unsharded step's decisions; meanwhile the pyramid cases
    (2 ranks each, in one launch), and here the whole forwards."""
    root, jobs = jax_jobs
    pool = concurrent.futures.ThreadPoolExecutor(2)
    try:
        jcfg, cfg = jconfig.VideoKNetConfig(**DECODER), tconfig.VideoKNetConfig(**DECODER)
        model = shallow_neck(VideoKNet(cfg, generator=torch.Generator().manual_seed(0),
                                       device="cpu"))
        spread_sampling_offsets(model.neck, torch.Generator().manual_seed(1), REACH)
        with torch.no_grad():  # a kernel left at zero would move by AdamW's step alone,
            # lr * g / (|g| + eps), which no parameter tolerance holds where g is near 0
            kernel = model.neck.layer0.self_attn.sampling_offsets.weight
            kernel.normal_(0.0, REACH / kernel.shape[1] ** 0.5,
                           generator=torch.Generator().manual_seed(2))
        variables = perturbed_variables(model, seed=1)  # (it redraws every bias)
        variables["params"]["neck"]["layer0"]["self_attn"]["sampling_offsets"]["bias"] = (
            model.neck.layer0.self_attn.sampling_offsets.bias.detach().numpy().copy())
        batch = tvps.make_synthetic_batch(cfg, 1, JAX_HW, seed=0, device="cpu")
        for tag, n_model in (("sharded", 2), ("whole", 1)):
            _send_spec(root, f"deform_{tag}", dict(
                job="sharded_vps", cfg=jcfg, variables=variables, n_data=1, n_model=n_model,
                shallow=True, batches=[(batch.img.numpy(), batch.ref_img.numpy(),
                                        [x.numpy() for x in batch.gt],
                                        [x.numpy() for x in batch.ref_gt])]))
        cases = {name: _pyramid_case(*case) for name, case in PYRAMIDS.items()}

        def bands():
            got = dp_check.run_ranks(2, [cases[c][0] for c in cases],
                                     os.path.join(root, "bands"), nice=NICE)
            return {c: (cases[c][1], [r[i] for r in got]) for i, c in enumerate(cases)}

        futures = {"bands": pool.submit(bands)}

        def jax_then_ranks():
            """The port's 2 ranks, started at once (they build the model
            while JAX compiles), replaying the unsharded step's ReLU
            decisions and mask-pool binarizations in the port's call order,
            which they wait for."""
            got, tmp = {}, os.path.join(root, "jax")
            relus, pools = os.path.join(tmp, "relus.pkl"), os.path.join(tmp, "pools.pkl")

            def decisions():
                with torch.no_grad():  # while JAX compiles
                    order = relu_call_order(
                        model, lambda: model.forward_train(batch.img, batch.ref_img))
                got["whole"] = whole = _collect(*jobs["whole"])
                dp_check.write_relus(pools, [[torch.from_numpy(d) for d in whole["pools"][0]]])
                dp_check.write_relus(relus, [jax_relu_decisions(whole["relus"][0], model, None,
                                                                order)])
                got["want"] = _collect(*jobs["sharded"])

            weights = {k: v.clone() for k, v in load_flax_variables(
                model, variables).state_dict().items()}
            spec = dict(kind="vps", cfg=cfg, seed=0, n_model=2, neck_layers=NECK_LAYERS,
                        batches=[batch], relus=relus, pools=pools, weights=weights)
            ranks = dp_check.run_ranks(2, [spec], tmp, threads=2, nice=NICE,
                                       while_running=decisions)
            return got["want"], [r[0] for r in ranks], got["whole"]

        futures["jax"] = pool.submit(jax_then_ranks)
        out = {tag: f.result() for tag, f in futures.items()}
        *out["jax"], out["jax_whole"] = out["jax"]
        return dict(**out, model=model)
    finally:
        pool.shutdown(wait=True)


# ------------------------------------------------------------------ no run needed


@pytest.mark.parametrize("index", [0, 1])
def test_reference_points_and_code_at_376_rows_equal_the_whole_levels(index):
    """376 rows over 2 (bands of 192 + 184): at strides 8, 16 and 32 (47,
    24 and 12 rows over 156, 78 and 39 columns) each rank's reference
    points and positional code are the whole level's at its rows, bit for
    bit."""
    shapes = [(47, 156), (24, 78), (12, 39)]
    whole_ref = msdeform_decoder._reference_points(shapes).split([h * w for h, w in shapes])
    band = model_axis.Split("rows", None, index, 2, tuple(model_axis.band_units(376, 2)),
                            image=(376, 1248))
    token = model_axis._BAND.set(band)
    try:
        mine = [model_axis.map_bands(band, w)[index] for _, w in shapes]
        local = [(b - a, w) for (a, b), (_, w) in zip(mine, shapes)]
        got_ref = msdeform_decoder._reference_points(local).split([h * w for h, w in local])
        got_pe = [band_positional_encoding(h, w, 64) for h, w in local]
    finally:
        model_axis._BAND.reset(token)
    assert [b - a for a, b in mine] == ([24, 12, 6] if index == 0 else [23, 12, 6])
    for (a, b), (h, w), want, got, pe in zip(mine, shapes, whole_ref, got_ref, got_pe):
        assert torch.equal(got, want.reshape(h, w, 2)[a:b].reshape(-1, 2))
        assert torch.equal(pe, sine_positional_encoding(h, w, 64)[a:b])


def test_sampling_core_takes_fewer_queries_than_values():
    """A band's queries sample the whole value maps: `ms_deform_attn_core`
    with Q below the maps' tokens gives the rows of the whole query set's
    output, bit for bit."""
    rng = np.random.RandomState(0)
    shapes = [(6, 8), (3, 4)]
    values = [torch.from_numpy(rng.randn(1, h, w, 2, 4).astype(np.float32)) for h, w in shapes]
    q = sum(h * w for h, w in shapes)
    locs = torch.from_numpy(rng.rand(1, q, 2, 2, 3, 2).astype(np.float32))
    attn = torch.softmax(torch.from_numpy(rng.randn(1, q, 2, 6).astype(np.float32)), -1)
    attn = attn.reshape(1, q, 2, 2, 3)
    whole = ms_deform_attn_core(values, locs, attn)
    part = ms_deform_attn_core(values, locs[:, 10:25], attn[:, 10:25])
    assert part.shape == (1, 15, 8) and torch.equal(part, whole[:, 10:25])


# ------------------------------------------------------------------ against JAX


def test_jax_sharded_step_agrees_with_its_unsharded_one(runs):
    """Why the port is held to the sharded step: its losses and gradient
    equal the unsharded step's within the tolerances the port is held to."""
    (want, _), whole = runs["jax"], runs["jax_whole"]
    for k, w in want["losses"][0].items():
        assert abs(whole["losses"][0][k] - w) <= LOSS_REL * max(abs(w), 1e-6), k
    for k, w in want["grads"].items():
        scale = float(np.abs(want["grads"][weight_of(k)]).max())
        assert float(np.abs(whole["grads"][k] - w).max()) <= GRAD_REL * max(scale, 1e-12), k


def test_decoder_band_split_losses_match_jax_sharded_step(runs):
    want, ranks = runs["jax"]
    for r in ranks:
        assert r["replayed"] == [True]
        (got,) = r["losses"]
        assert set(got) == set(want["losses"][0])
        for k, w in want["losses"][0].items():
            assert abs(got[k] - w) <= LOSS_REL * max(abs(w), 1e-6), (k, got[k], w)


def test_decoder_band_split_gradient_matches_jax_sharded_step(runs):
    """The first step's gradient on every rank (summed over the two bands:
    the replicated heads counted once) against JAX's, leaf by leaf; the
    decoder's value projections among the leaves that moved."""
    want, ranks = runs["jax"]
    model = runs["model"]
    moved = 0
    for r in ranks:
        grads = state_dict_to_flax(model, {n: r["grads"].get(n, torch.zeros_like(p))
                                           for n, p in model.named_parameters()})
        for k, w in want["grads"].items():
            scale = float(np.abs(want["grads"][weight_of(k)]).max())
            assert float(np.abs(grads[k] - w).max()) <= GRAD_REL * max(scale, 1e-12), k
            moved += float(np.abs(w).max()) > 0
    assert moved > len(ranks) * len(want["grads"]) // 2
    assert all(float(np.abs(want["grads"][f"params/neck/layer0/self_attn/{leaf}/kernel"]).max())
               > 0 for leaf in ("value_proj0", "value_proj2", "sampling_offsets"))


def test_decoder_band_split_state_matches_jax_sharded_step(runs):
    """The parameters after the step against JAX's; every rank's state the
    same, bit for bit."""
    want, ranks = runs["jax"]
    got = state_dict_to_flax(runs["model"], ranks[0]["state"])
    for k, w in want["params"].items():
        assert rel_err(got[k], w) <= STATS_REL, k
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_decoder_step_reaches_what_it_checks(runs):
    """Each rank's backbone took its band of [ref; key] (2 images of 64 of
    the 128 rows) and gathered the encoder's value maps: the bytes as
    `dp_check.decoder_gather_bytes` reckons them for one layer."""
    _, ranks = runs["jax"]
    assert [r["inputs"] for r in ranks] == [[(2, JAX_HW[0] // 2, JAX_HW[1], 3)]] * 2
    want = dp_check.decoder_gather_bytes(JAX_HW, 2, images=2, layers=NECK_LAYERS)
    assert want == 774144
    assert all(r["comm"][0]["gather"] == want for r in ranks)
    assert all(r["comm"][0]["halo"] > 0 and r["comm"][0]["reduce"] > 0 for r in ranks)


# ------------------------------------------------------------------ the band split alone


@pytest.mark.parametrize("case", list(PYRAMIDS))
def test_decoder_bands_match_the_whole_forward(runs, case):
    name, n_model, hw = PYRAMIDS[case]
    whole, ranks = runs["bands"][case]
    for i, want in enumerate(whole["levels"]):
        scale = float(want.abs().max())
        for r in ranks:  # each rank's band of the level, no gather of the pyramid
            a, b = r["rows"][i]
            assert float((r["levels"][i] - want[:, a:b]).abs().max()) <= LEVEL_REL * scale, (
                case, i)
        assert [r["rows"][i][0] for r in ranks][0] == 0
        assert ranks[-1]["rows"][i][1] == want.shape[1]
    grad = sum(r["grad_img"] for r in ranks)
    assert rel_err(grad.numpy(), whole["grad_img"].numpy()) <= HALO_GRAD_REL
    for k, g in whole["grads"].items():
        got = sum(r["grads"][k] for r in ranks)
        assert float((got - g).abs().max()) <= HALO_GRAD_REL * float(g.abs().max()), (case, k)
    units = model_axis.band_units(hw[0], n_model)
    assert [r["inputs"] for r in ranks] == [[(1, 32 * units[0], hw[1], 3)],
                                            [(1, hw[0] - 32 * units[0], hw[1], 3)]]
    gather = dp_check.decoder_gather_bytes(hw, n_model, images=1, layers=6)
    assert all(r["comm"]["gather"] == gather for r in ranks), (case, gather)
