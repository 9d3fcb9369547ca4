"""The band split of the mesh's `model` axis at heights that are not a
multiple of 32 (`parallel/model_axis.py`): every band but the last ends on
a whole stride-32 row, the last holds the partial one, and every map's
rows come from its global geometry (its columns tell its stride), against
the JAX package and against the port in one process.

The heights: JAX's whole VPS step runs at a height exactly where it is a
multiple of 8 (its stride-8 mask logits, upscaled, must match the GT's
floor(H / 2) rows; `tests/torch_port_jax_jobs.py:whole_step_heights`
traces the one-stage R-50 loss at 64-80 rows), and the band split takes
exactly those heights (with at least as many stride-32 rows as bands).

Against JAX: the port's one-stage R-50 VPS step (`VideoKNetConfig(
max_insts=4)`, one stage) over 2 gloo ranks on a 1x2 mesh against JAX's
`make_sharded_train_step` on 2 virtual CPU devices at 144x96 (5 stride-32
rows, the last half: bands of 96 + 48 rows), the ranks replaying JAX's
ReLU decisions. JAX's sharded step agrees there with its unsharded one but
for one ReLU input on the other side of zero (layer3's fifth block), so
it is the sharded step that the port is held to: the losses within
LOSS_REL, the gradient within GRAD_REL of each leaf's largest magnitude,
the parameters after the step within STATS_REL (the tolerances of
`tests/test_torch_port_model_axis.py`).

Against the port in one process (`tools/dp_check.py`, each case's ranks in
processes of their own, at nice 19 beside the JAX jobs):
- ResNet-50 + FPN in bands (`dp_check.pyramid_share`) against the whole
  forward at 72x96 over 2 (64 + 8 rows: the last band holds one row at
  strides 8, 16 and 32 alike) and 80x192 over 3 (32 + 32 + 16), Swin-tiny
  and MiT-b0 + FPN at 120x96 over 2 (64 + 56: MiT's stride-8 spatial
  reduction pads the 30-row level 1 + 1, so its windows straddle the band
  edge); each rank's band of each level within LEVEL_REL of the level's
  largest magnitude, the image's and the parameters' gradients summed
  over the ranks within HALO_GRAD_REL;
- the resizes whose factor is not whole (`dp_check.resize_pieces`) at
  376x64 and 720x64 over 2: the FPN's nearest top-down resize (24 -> 47
  rows at 376), the Semantic-FPN's antialiased shrink (48 -> 47), and its
  stride-32 chain (at 720: 23 -> 46 rows, not the stride-16 level's 45,
  -> 92 -> 90); the outputs bit for bit, the inputs' gradients (summed
  over the ranks, in another order) within RESIZE_GRAD_REL;
- one whole one-stage R-50 VPS step at 72x96 over 2 ranks against one
  process, the ranks replaying its ReLU decisions: the losses within
  STEP_LOSS_REL, the gradient within STEP_GRAD_REL of each leaf's scale.
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
from video_knet_tpu_torch.models.backbones import backbone_and_neck, build_backbone, build_neck
from video_knet_tpu_torch.models.layers import (
    init_parameters,
    resize_bilinear,
    resize_nearest,
    upsample2x,
)
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools.train_check import relu_pattern
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.utils.convert import load_flax_variables, state_dict_to_flax

JAX_HW = (144, 96)  # 5 stride-32 rows, the last half one: bands of 96 + 48
STEP_HW = (72, 96)  # 3 stride-32 rows: bands of 64 + 8
ONE_STAGE = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
# tests/test_torch_port_model_axis.py's tolerances against JAX's sharded step
LOSS_REL = 5e-4
STATS_REL = 1e-4
GRAD_REL = 1e-3
# the band split against the whole forward, in the port
LEVEL_REL, HALO_GRAD_REL = 1e-5, 1e-4
RESIZE_GRAD_REL = 1e-6
STEP_LOSS_REL, STEP_GRAD_REL = 1e-4, 1e-3
PYRAMIDS = {"resnet50_72x96_over_2": ("resnet50", 2, (72, 96)),
            "resnet50_80x192_over_3": ("resnet50", 3, (80, 192)),
            "swin_tiny_120x96_over_2": ("swin_tiny", 2, (120, 96)),
            "mit_b0_120x96_over_2": ("mit_b0", 2, (120, 96))}
RESIZE_HW = {"376x64": (376, 64), "720x64": (720, 64)}
RESIZE_C = 8
HEIGHTS = tuple(range(64, 82, 2))  # the heights JAX's whole step is traced at
NICE = 19  # the port's processes yield the cores to the JAX jobs while these compile


def _jax_cfg():
    return jconfig.VideoKNetConfig(max_insts=4, **ONE_STAGE)


def _cfg():
    return tconfig.VideoKNetConfig(max_insts=4, **ONE_STAGE)


def _pyramid(name: str, seed: int = 0):
    """A seeded backbone + FPN in eval mode, ResNet's statistics off their
    init."""
    gen = torch.Generator().manual_seed(seed)
    backbone = build_backbone(name)
    neck = build_neck("fpn", backbone)
    init_parameters(backbone, gen)
    init_parameters(neck, gen)
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
    spec = dict(kind="pyramid", n_model=n_model, backbone=name, img=img, cotangents=cot,
                weights=(backbone.state_dict(), neck.state_dict()), relus=relus or None)
    return spec, whole


def _resize_case(hw) -> dict:
    """The resize pieces' spec at image size `hw`: seeded maps at strides
    16 and 32, the stride-16 one upsampled twice, a stride-8 cotangent."""
    rng = np.random.RandomState(hw[0])
    h, w = hw

    def f(s, up=1):
        return torch.from_numpy(rng.randn(1, up * -(-h // s), up * -(-w // s),
                                          RESIZE_C).astype(np.float32))

    return dict(kind="resize_pieces", n_model=2, hw=hw, x16=f(16), up=f(16, 2), x32=f(32),
                cot=f(8))


@pytest.fixture(scope="module", autouse=True)
def jax_jobs(tmp_path_factory):
    """JAX's sharded step and the heights its whole step traces at, started
    with the file: they import (the step later traces and compiles, the
    longest work here) while the tests that need no run go first; then
    `runs` sends their specs."""
    root = str(tmp_path_factory.mktemp("model_axis_heights"))
    jobs = {"step": _spawn(root, "heights_step", None, nice=0, devices=2),
            "heights": _spawn(root, "heights_traced", None, nice=5)}
    yield root, jobs
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(jax_jobs):
    """JAX's sharded step in a process of its own, then the port's ranks
    replaying its ReLU decisions; meanwhile the pyramid and resize cases
    (2 ranks, then 3) and the 72-row step (its one-process run, then its
    ranks), each in processes of their own, and here the whole forwards."""
    root, jobs = jax_jobs
    pool = concurrent.futures.ThreadPoolExecutor(4)
    try:
        jcfg, cfg = _jax_cfg(), _cfg()
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        variables = perturbed_variables(model, seed=1)
        batch = tvps.make_synthetic_batch(cfg, 1, JAX_HW, seed=0, device="cpu")
        _send_spec(root, "heights_step", dict(
            job="sharded_vps", cfg=jcfg, variables=variables, n_data=1, n_model=2, batches=[(
                batch.img.numpy(), batch.ref_img.numpy(), [x.numpy() for x in batch.gt],
                [x.numpy() for x in batch.ref_gt])]))
        _send_spec(root, "heights_traced", dict(job="whole_step_heights", cfg=jcfg,
                                                heights=HEIGHTS, width=96))

        def step():
            spec = dict(kind="vps", cfg=cfg, seed=0, n_model=2, batches=[
                tvps.make_synthetic_batch(cfg, 1, STEP_HW, seed=0, device="cpu")])
            tmp = os.path.join(root, "step")
            one, relus = dp_check.run_reference([spec], tmp, nice=NICE)[0]
            return one, [r[0] for r in dp_check.run_ranks(2, [{**spec, "relus": relus}], tmp,
                                                           nice=NICE)]

        futures = {"step": pool.submit(step)}
        cases = {name: _pyramid_case(*case) for name, case in PYRAMIDS.items()}
        resize = {name: _resize_case(hw) for name, hw in RESIZE_HW.items()}

        def bands():
            """The 2-rank cases, then the 3-rank one."""
            two = [c for c in cases if PYRAMIDS[c][1] == 2]
            got = dp_check.run_ranks(2, [cases[c][0] for c in two] + list(resize.values()),
                                     os.path.join(root, "bands_2"), nice=NICE)
            out = {c: (cases[c][1], [r[i] for r in got]) for i, c in enumerate(two)}
            out.update({c: [r[len(two) + i] for r in got] for i, c in enumerate(resize)})
            three = [c for c in cases if PYRAMIDS[c][1] == 3]
            got = dp_check.run_ranks(3, [cases[c][0] for c in three],
                                     os.path.join(root, "bands_3"), nice=NICE)
            out.update({c: (cases[c][1], [r[i] for r in got]) for i, c in enumerate(three)})
            return out

        futures["bands"] = pool.submit(bands)

        def jax_then_ranks():
            """The port's 2 ranks, started at once (they build the model
            while JAX compiles), replaying JAX's ReLU decisions in the
            port's call order, which they wait for."""
            got, tmp = {}, os.path.join(root, "jax")
            relus = os.path.join(tmp, "relus.pkl")

            def decisions():
                with torch.no_grad():  # while JAX compiles
                    order = relu_call_order(
                        model, lambda: model.forward_train(batch.img, batch.ref_img))
                got["want"] = want = _collect(*jobs["step"])
                dp_check.write_relus(relus, [jax_relu_decisions(want["relus"][0], model, None,
                                                                order)])

            weights = {k: v.clone() for k, v in load_flax_variables(
                model, variables).state_dict().items()}
            spec = dict(kind="vps", cfg=cfg, seed=0, n_model=2, batches=[batch], relus=relus,
                        weights=weights)
            ranks = dp_check.run_ranks(2, [spec], tmp, threads=2, nice=NICE,
                                       while_running=decisions)
            return got["want"], [r[0] for r in ranks]

        futures["jax"] = pool.submit(jax_then_ranks)
        out = {tag: f.result() for tag, f in futures.items()}
        out["bands"].update(resize=resize)
        out["heights"] = _collect(*jobs["heights"])
        return dict(**out, model=model)
    finally:
        pool.shutdown(wait=True)


# ------------------------------------------------------------------ the layout, what raises


def test_band_layout_puts_the_partial_stride_32_row_in_the_last_band():
    """376 rows over 2: 6 + 6 units, bands of 192 + 184; 720 over 2: 12 +
    11, 384 + 336; at stride s rank i owns [a_i / s, a_{i+1} / s), the last
    rank up to the level's ceil(H / s): 376's stride-8 level of 47 rows is
    24 + 23, its stride-16 one 12 + 12."""
    assert model_axis.band_units(376, 2) == [6, 6]
    assert model_axis.band_units(720, 2) == [12, 11]
    assert model_axis.band_units(72, 2) == [2, 1]
    band = model_axis.Split("rows", None, 1, 2, (6, 6), image=(376, 1248))
    assert model_axis.band_rows(376, 1248, band) == slice(192, 376)
    assert model_axis.level_bands(23, 156, band) == ((0, 24), (24, 47))
    assert model_axis.level_bands(12, 78, band) == ((0, 12), (12, 24))
    assert model_axis.level_height(23, 156) == 23  # outside a band: the rows themselves
    band = model_axis.Split("rows", None, 1, 2, (12, 11), image=(720, 1280))
    assert model_axis.level_bands(42, 160, band) == ((0, 48), (48, 90))
    assert model_axis.level_bands(11, 40, band) == ((0, 12), (12, 23))
    # the stride-32 level upsampled twice: 46 rows, not stride 16's 45
    up = model_axis.scaled_bands(model_axis.map_bands(band, 40), 2)
    assert up == ((0, 24), (24, 46)) and model_axis.band_rows(46, 80, band) == slice(24, 46)
    with pytest.raises(ValueError, match="is not this rank's rows"):
        model_axis.level_bands(22, 80, band)  # the upsampled map's band is not a level's


def test_the_72_row_band_holds_one_row_at_strides_8_to_32():
    """72 rows over 2 (64 + 8): the last band holds one row at strides 8,
    16 and 32 alike, so its rows cannot tell the level; its columns do, and
    both ranks see the same levels: 9 rows (8 + 1), 5 (4 + 1), 3 (2 + 1)."""
    for index in (0, 1):
        band = model_axis.Split("rows", None, index, 2, (2, 1), image=(72, 96))
        for s, want in ((1, ((0, 64), (64, 72))), (4, ((0, 16), (16, 18))),
                        (8, ((0, 8), (8, 9))), (16, ((0, 4), (4, 5))), (32, ((0, 2), (2, 3)))):
            rows = want[index][1] - want[index][0]
            assert model_axis.level_bands(rows, 96 // s, band) == want, (index, s)


def _fake_split(count: int = 2):
    """A band split with no process group: what raises, raises before any
    collective."""
    return model_axis._SPLIT.set(model_axis.Split("rows", None, 0, count))


@pytest.mark.parametrize("name", ("resnet50", "swin_tiny", "mit_b0"))
def test_band_split_raises_where_jax_whole_step_fails(name):
    """70 rows: JAX's whole step fails (its mask logits' 2 * ceil(70 / 8)
    rows, upscaled, against the GT's floor(70 / 2)), and so does the band
    split, before anything runs; so does an image too narrow for its maps'
    columns to tell their strides apart."""
    bb = build_backbone(name)
    nk = build_neck("fpn", bb)
    token = _fake_split()
    try:
        with pytest.raises(ValueError, match="JAX's whole VPS step refuses 70 image rows"):
            backbone_and_neck(bb, nk, torch.zeros(1, 70, 64, 3))
        with pytest.raises(ValueError, match="16 columns wide is too narrow"):
            backbone_and_neck(bb, nk, torch.zeros(1, 64, 16, 3))
    finally:
        model_axis._SPLIT.reset(token)


# ------------------------------------------------------------------ against JAX


def test_the_split_takes_the_heights_jax_whole_step_runs_at(runs):
    """JAX's whole step traces at 64, 72 and 80 rows and fails at every
    other even height between; the band split over 2 takes exactly the
    heights JAX runs at."""
    traced = runs["heights"]
    assert [h for h in HEIGHTS if traced[h] is None] == [64, 72, 80]
    assert all("does not match" in traced[h] for h in HEIGHTS if traced[h] is not None)
    for h in HEIGHTS:
        try:
            model_axis.band_units(h, 2)
            takes = True
        except ValueError:
            takes = False
        assert takes == (traced[h] is None), h


def test_band_split_losses_match_jax_sharded_step(runs):
    want, ranks = runs["jax"]
    for r in ranks:
        assert r["replayed"] == [True]
        (got,) = r["losses"]
        assert set(got) == set(want["losses"][0])
        for k, w in want["losses"][0].items():
            assert abs(got[k] - w) <= LOSS_REL * max(abs(w), 1e-6), (k, got[k], w)


def test_band_split_gradient_matches_jax_sharded_step(runs):
    """The first step's gradient on every rank (summed over the two bands:
    the replicated heads counted once) against JAX's, leaf by leaf."""
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


def test_band_split_state_matches_jax_sharded_step(runs):
    """The parameters after the step against JAX's; every rank's state the
    same, bit for bit; each rank's backbone took its band of [ref; key]
    (96 and 48 rows) and exchanged rows, gathering nothing."""
    want, ranks = runs["jax"]
    got = state_dict_to_flax(runs["model"], ranks[0]["state"])
    for k, w in want["params"].items():
        assert rel_err(got[k], w) <= STATS_REL, k
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    assert [r["inputs"] for r in ranks] == [[(2, 96, 96, 3)], [(2, 48, 96, 3)]]
    for r in ranks:
        comm = r["comm"][0]
        assert comm["halo"] > 0 and comm["reduce"] > 0 and comm["gather"] == 0


# ------------------------------------------------------------------ against the port


@pytest.mark.parametrize("case", list(PYRAMIDS))
def test_band_split_matches_the_whole_forward(runs, case):
    name, n_model, hw = PYRAMIDS[case]
    whole, ranks = runs["bands"][case]
    for i, want in enumerate(whole["levels"]):
        scale = float(want.abs().max())
        edges = [tuple(r["rows"][i]) for r in ranks]
        for r, (a, b) in zip(ranks, edges):  # each rank's band of the level, no gather
            assert float((r["levels"][i] - want[:, a:b]).abs().max()) <= LEVEL_REL * scale, (
                case, i)
        # rank j starts at its image rows' start over the level's stride
        stride = hw[1] // want.shape[2]
        starts = [32 * sum(model_axis.band_units(hw[0], n_model)[:j]) // stride
                  for j in range(n_model)]
        assert edges == list(zip(starts, [*starts[1:], want.shape[1]])), (case, i)
    grad = sum(r["grad_img"] for r in ranks)
    assert rel_err(grad.numpy(), whole["grad_img"].numpy()) <= HALO_GRAD_REL
    assert set(whole["grads"]) == set(ranks[0]["grads"])
    for k, g in whole["grads"].items():
        got = sum(r["grads"][k] for r in ranks)
        assert float((got - g).abs().max()) <= HALO_GRAD_REL * float(g.abs().max()), (case, k)
    units = model_axis.band_units(hw[0], n_model)
    rows = [32 * u for u in units[:-1]] + [hw[0] - 32 * sum(units[:-1])]
    assert [r["inputs"] for r in ranks] == [[(1, n, hw[1], 3)] for n in rows]
    assert all(r["comm"]["halo"] > 0 and (r["comm"]["gather"] > 0) == (name == "mit_b0")
               for r in ranks)


def _whole_resizes(spec: dict) -> dict:
    """`dp_check.resize_pieces` on the whole map, here."""
    return dp_check.resize_pieces(dp_check.DataMesh(), "cpu", spec)


@pytest.mark.parametrize("case", list(RESIZE_HW))
def test_banded_resizes_match_the_whole_map(runs, case):
    """Each rank's output rows bit for bit the whole map's; the inputs'
    gradients, each rank's summed with what it lent, within
    RESIZE_GRAD_REL."""
    spec = runs["bands"]["resize"][case]
    ranks = runs["bands"][case]
    whole = _whole_resizes(spec)
    h8 = spec["cot"].shape[1]
    split = model_axis.band_units(spec["hw"][0], 2)
    start8 = 32 * split[0] // 8
    for name in ("nearest", "shrink", "upsample"):
        want = whole[name][1]
        got = torch.cat([r[name][1] for r in ranks], 1)
        assert got.shape[1] == h8 and ranks[0][name][1].shape[1] == start8
        assert torch.equal(got, want), (case, name)
        gwant = whole[f"{name}.grad"][1]
        ggot = torch.cat([r[f"{name}.grad"][1] for r in ranks], 1)
        scale = float(gwant.abs().max())
        assert float((ggot - gwant).abs().max()) <= RESIZE_GRAD_REL * scale, (case, name)
    assert all(r["comm"]["halo"] > 0 and r["comm"]["gather"] == 0 for r in ranks)


def test_resize_cases_reach_what_they_check(runs):
    """At 376 rows the FPN's stride-16 level (24 rows) resizes to the 47
    of stride 8, and the upsampled 48 shrink to 47; at 720 the stride-32
    level's 23 rows upsample to 46, which is no level (stride 16 has 45),
    then to 92, shrunk to 90."""
    spec = runs["bands"]["resize"]
    assert spec["376x64"]["x16"].shape[1] == 24 and spec["376x64"]["cot"].shape[1] == 47
    assert spec["376x64"]["up"].shape[1] == 48
    assert spec["720x64"]["x32"].shape[1] == 23 and spec["720x64"]["cot"].shape[1] == 90
    assert 2 * 23 != -(-720 // 16)


def test_whole_resizes_are_the_layers_own():
    """`resize_pieces` on the whole map is the layers' plain resizes."""
    spec = _resize_case((376, 64))
    whole = _whole_resizes(spec)
    assert torch.equal(whole["nearest"][1],
                       resize_nearest(spec["x16"], (47, 8), dims=(1, 2)))
    assert torch.equal(whole["shrink"][1], resize_bilinear(spec["up"], (47, 8)))
    assert torch.equal(whole["upsample"][1], resize_bilinear(
        upsample2x(upsample2x(spec["x32"])), (47, 8)))


def test_uneven_height_step_equals_one_process(runs):
    """One-stage R-50 VPS at 72x96 over 2 bands (64 + 8 rows), one step:
    each rank against the one-process step, replaying its ReLU decisions."""
    one, ranks = runs["step"]
    assert [r["inputs"] for r in ranks] == [[(2, 64, 96, 3)], [(2, 8, 96, 3)]]
    for r in ranks:
        assert r["replayed"] == [True]
        for k, w in one["losses"][0].items():
            got = r["losses"][0][k]
            assert abs(got - w) <= STEP_LOSS_REL * max(abs(w), 1e-6), (k, got, w)
        assert set(r["grads"]) == set(one["grads"])
        for k, g in one["grads"].items():
            scale = float(g.abs().max())
            if k.endswith(".key.bias"):  # zero up to rounding
                scale = float(one["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((r["grads"][k] - g).abs().max()) <= STEP_GRAD_REL * max(scale, 1e-12), k
        assert r["comm"][0]["halo"] > 0 and r["comm"][0]["gather"] == 0
