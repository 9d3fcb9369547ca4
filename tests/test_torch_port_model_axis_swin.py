"""The band split of Swin and MiT over the mesh's `model` axis, with bands of
uneven height (`parallel/model_axis.py`, `models/swin.py`, `models/mit.py`),
against the JAX package and against the port in one process.

Against JAX: the port's Swin-tiny VPS step (`train_check.swin_check_cfg`
under the trained tiny config's 64-channel heads, cut to one stage, drop
path 0) over 2 gloo ranks on a 1x2 mesh against JAX's
`make_sharded_train_step` on 2 virtual CPU devices (the image height
sharded over `model`) at 160x96: 5 stride-32 rows, so bands of 96 + 64
rows, windows that straddle the band edge at every stage, and a shift at
stages 1 and 2 whose last window joins the map's last rows to its first
(the ring). JAX's sharded step agrees with
its unsharded one at this size (held below: every gradient leaf within
9e-5 of its scale on an AVX-512 host, 7.3e-6 on an earlier one). The JAX
jobs, the sharded step and the unsharded one, run in processes of their
own (`tests/torch_port_jax_jobs.py`), started first; the port's ranks
replay the unsharded step's ReLU decisions and mask-pool binarizations,
not the sharded step's: XLA computes a band's edge rows on both devices,
and a ReLU input within its rounding of 0 there can be decided both ways
in one sharded step (on an AVX-512 host the sharded step's capture passed
a Semantic-FPN GroupNorm output of 1.7e-7 of its scale, stride-8 row 9,
the first device's last, while the gradient it reported did not: a replay
of that capture moved the ranks' l2_conv1 kernel gradient 1.6e-2 of its
scale off JAX's); the unsharded step decides each input once. One step: the losses within LOSS_REL, the gradient
within GRAD_REL of each leaf's largest magnitude, the parameters after
the step within STATS_REL (the tolerances of
`tests/test_torch_port_model_axis.py`).

Against the port in one process (`tools/dp_check.py`, each case's ranks in
processes of their own, at nice 19 beside the JAX compile):
- Swin-tiny + FPN and MiT-b0 + FPN in bands (`dp_check.pyramid_share`)
  against the whole forward: 2 bands of 64x96, 4 of 128x192, and uneven
  bands, 160 rows over 2 (3 + 2 stride-32 rows) and 224 over 4 (2 + 2 + 2 +
  1: at Swin's stage 4 one window spans all four bands); each rank's band
  of each level within 1e-5 of the level's largest magnitude, the image's
  and the parameters' gradients summed over the ranks within 1e-4;
- one Swin-tiny VPS step with drop path 0.3 over 2 band ranks at 160x96
  against one process: losses within 1e-4, the gradient within 1e-3.
Also the cases ROADMAP F7d named, which the split now runs (the
MSDeformAttn decoder over Swin-tiny and MiT-b0, DetectoRS R-50 and the RFP
Swin-tiny, on 2 bands of 64x96), the band layout, the window plan's ring
and the drop-path draws.
"""

import concurrent.futures
import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch
import trained_golden_common as jtg
from torch_port_common import (
    _collect,
    _send_spec,
    _spawn,
    assert_rfp_bands,
    jax_relu_decisions,
    perturbed_variables,
    rel_err,
    relu_call_order,
    rfp_pyramid_case,
    seeded_rfp,
    weight_of,
)

from video_knet_tpu_torch.models.backbones import backbone_and_neck, build_backbone, build_neck
from video_knet_tpu_torch.models.layers import init_parameters
from video_knet_tpu_torch.models.swin import window_plan
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.parallel import mesh as tmesh
from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.parallel.mesh import DataMesh
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.train_check import (
    relu_pattern,
    spread_sampling_offsets,
    swin_check_cfg,
)
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.utils.convert import load_flax_variables, state_dict_to_flax

HW = (160, 96)  # 5 stride-32 rows: bands of 96 + 64
ONE_STAGE = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
# tests/test_torch_port_model_axis.py's tolerances against JAX's sharded step
LOSS_REL = 5e-4
STATS_REL = 1e-4
GRAD_REL = 1e-3
# the band split against the whole forward, in the port
LEVEL_REL, HALO_GRAD_REL = 1e-5, 1e-4
BANDS = {"2_bands_64x96": (2, (64, 96)), "4_bands_128x192": (4, (128, 192)),
         "160_rows_over_2": (2, (160, 96)), "224_rows_over_4": (4, (224, 64))}
BACKBONES = ("swin_tiny", "mit_b0")
RFP_BACKBONES = ("detectors_r50", "swin_tiny_rfp")
DECODER_CASE = "2_bands_64x96"  # each backbone with the MSDeformAttn decoder too
NICE = 19  # the port's processes yield the cores to the JAX job while it compiles


def _cfgs():
    """Swin-tiny under the trained tiny config's heads, one stage: (JAX's,
    the port's)."""
    return tuple(dataclasses.replace(swin_check_cfg(m.tiny_cfg()), **ONE_STAGE)
                 for m in (jtg, tg))


def _pyramid(name: str, seed: int = 0, neck_type: str = "fpn"):
    """A seeded backbone + FPN (or `neck_type`) in eval mode (the decoder's
    sampling offsets reaching a few pixels)."""
    gen = torch.Generator().manual_seed(seed)
    backbone = build_backbone(name)
    neck = build_neck(neck_type, backbone)
    init_parameters(backbone, gen)
    init_parameters(neck, gen)
    if neck_type == "msdeform_pixel_decoder":
        spread_sampling_offsets(neck, gen)
    return backbone.eval(), neck.eval()


def _whole_pyramid(backbone, neck, img, cot) -> dict:
    """The whole forward and backward, and its ReLU decisions (the
    decoder's FFN), which the bands replay."""
    x = img.clone().requires_grad_(True)
    relus: list = []
    with relu_pattern(relus):
        levels = backbone_and_neck(backbone, neck, x)
    sum((lv * c).sum() for lv, c in zip(levels, cot)).backward()
    grads = {f"{tag}.{n}": p.grad.clone() for tag, m in (("backbone", backbone), ("neck", neck))
             for n, p in m.named_parameters() if p.grad is not None}
    for m in (backbone, neck):
        m.zero_grad(set_to_none=True)
    return dict(levels=[lv.detach() for lv in levels], grad_img=x.grad, grads=grads,
                relus=relus)


def _band_case(models: dict, name: str, n_model: int, hw,
               neck_type: str = "fpn") -> tuple[dict, dict]:
    """(the band split's spec, the whole forward and backward here; `name`
    a key of `models`, "<backbone>+decoder" for `neck_type`
    "msdeform_pixel_decoder")."""
    backbone, neck = models[name]
    rng = np.random.RandomState(n_model + hw[0])
    img = torch.from_numpy(rng.randn(1, *hw, 3).astype(np.float32))
    cot = [torch.from_numpy(rng.randn(1, hw[0] // s, -(-hw[1] // s), 256).astype(np.float32))
           for s in (4, 8, 16, 32)]
    whole = _whole_pyramid(backbone, neck, img, cot)
    spec = dict(kind="pyramid", n_model=n_model, backbone=name.split("+")[0], neck=neck_type,
                img=img, cotangents=cot, weights=models[f"{name}.weights"],
                relus=whole["relus"] or None)
    return spec, whole


@pytest.fixture(scope="module", autouse=True)
def jax_job(tmp_path_factory):
    """JAX's job, started with the file: it imports (and later traces and
    compiles, the longest work here) while the tests that need no run go
    first; then `runs` sends its spec."""
    root = str(tmp_path_factory.mktemp("model_axis_swin"))
    jobs = {tag: _spawn(root, f"model_axis_swin_{tag}", None, nice=0, devices=devices)
            for tag, devices in (("sharded", 2), ("whole", 1))}
    yield root, jobs
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(jax_job):
    """JAX's sharded step in a process of its own, then the port's ranks
    replaying its ReLU decisions; meanwhile the band cases (2 ranks, then 4)
    and the drop-path step (its one-process run, then its ranks), each in
    processes of their own, and here the whole pyramids."""
    root, jobs = jax_job
    pool = concurrent.futures.ThreadPoolExecutor(4)
    try:
        jcfg, cfg = _cfgs()
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        variables = perturbed_variables(model, seed=1)
        batch = tvps.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
        for tag, n_model in (("sharded", 2), ("whole", 1)):
            _send_spec(root, f"model_axis_swin_{tag}", dict(
                job="sharded_vps", cfg=jcfg, variables=variables, n_data=1, n_model=n_model,
                batches=[(batch.img.numpy(), batch.ref_img.numpy(),
                          [x.numpy() for x in batch.gt], [x.numpy() for x in batch.ref_gt])]))

        def drop_path():
            spec = dict(kind="vps", cfg=dataclasses.replace(cfg, backbone_drop_path_rate=0.3),
                        seed=0, n_model=2, batches=[batch])
            tmp = os.path.join(root, "drop_path")
            one, relus = dp_check.run_reference([spec], tmp, nice=NICE)[0]
            return one, [r[0] for r in dp_check.run_ranks(2, [{**spec, "relus": relus}], tmp,
                                                           nice=NICE)]

        futures = {"drop_path": pool.submit(drop_path)}
        models = {}
        for name in BACKBONES:  # one set of weights a backbone, pickled once a call
            models[name] = _pyramid(name)
            models[f"{name}.weights"] = tuple(m.state_dict() for m in models[name])
        cases = {(name, case): _band_case(models, name, *BANDS[case])
                 for case in BANDS for name in BACKBONES}
        for name in RFP_BACKBONES:  # no neck, 2 bands of 64x96
            cases[(name, DECODER_CASE)] = rfp_pyramid_case(seeded_rfp(name), name,
                                                           *BANDS[DECODER_CASE])
        for name in BACKBONES:  # with the MSDeformAttn decoder, 2 bands of 64x96
            key = f"{name}+decoder"
            models[key] = _pyramid(name, neck_type="msdeform_pixel_decoder")
            models[f"{key}.weights"] = tuple(m.state_dict() for m in models[key])
            cases[(key, DECODER_CASE)] = _band_case(models, key, *BANDS[DECODER_CASE],
                                                    "msdeform_pixel_decoder")

        def bands():
            """The 2-band cases, then the 4-band ones (one after the other:
            fewer processes beside the JAX compile)."""
            return {world: dp_check.run_ranks(
                world, [cases[k][0] for k in cases if BANDS[k[1]][0] == world],
                os.path.join(root, f"bands_{world}"), nice=NICE) for world in (2, 4)}

        futures["bands"] = pool.submit(bands)

        def jax_then_ranks():
            """The port's 2 ranks, started at once (they build the model
            while JAX compiles), replaying the ReLU decisions and mask-pool
            binarizations of JAX's unsharded step in the port's call order,
            which they wait for (the module doc says why)."""
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
            spec = dict(kind="vps", cfg=cfg, seed=0, n_model=2, batches=[batch], relus=relus,
                        pools=pools, weights=weights)
            # the last to run: the cores are free by then
            ranks = dp_check.run_ranks(2, [spec], tmp, threads=4, nice=NICE,
                                       while_running=decisions)
            return got["want"], [r[0] for r in ranks], got["whole"]

        futures["jax"] = pool.submit(jax_then_ranks)
        out = {tag: f.result() for tag, f in futures.items()}
        *out["jax"], out["jax_whole"] = out["jax"]
        by_world = out.pop("bands")
        out["bands"] = {}
        for world, ranks in by_world.items():
            keys = [k for k in cases if BANDS[k[1]][0] == world]
            for i, k in enumerate(keys):
                out["bands"][k] = (cases[k][1], [r[i] for r in ranks])
        return dict(**out, model=model, variables=variables)
    finally:
        pool.shutdown(wait=True)


# ------------------------------------------------------------------ the layout, what raises


def test_band_layout_follows_the_stride_32_rows():
    """736 rows over 2: 12 + 11 stride-32 rows, bands of 384 + 352; 224
    over 4: 2 + 2 + 2 + 1; at every level (told by its columns) a band is
    its units times the level's rows a unit."""
    assert model_axis.band_units(736, 2) == [12, 11]
    assert model_axis.band_units(224, 4) == [2, 2, 2, 1]
    band = model_axis.Split("rows", None, 1, 2, (12, 11), image=(736, 1280))
    assert model_axis.band_rows(736, 1280, band) == slice(384, 736)
    assert model_axis.band_rows(23, 40, band) == slice(12, 23)
    assert model_axis.level_bands(88, 320, band) == ((0, 96), (96, 184))
    with pytest.raises(ValueError, match="leaves the last of the bands"):
        model_axis.band_rows(20, 80, band)
    with pytest.raises(ValueError, match="not one of the model's maps"):
        model_axis.band_rows(50, 77, band)


def _fake_split(count: int = 2):
    """A band split with no process group: what raises, raises before any
    collective."""
    return model_axis._SPLIT.set(model_axis.Split("rows", None, 0, count))


@pytest.mark.parametrize("backbone,neck", [("detectors_r50", "fpn"), ("swin_tiny_rfp", "fpn"),
                                           ("swin_tiny", "msdeform_pixel_decoder"),
                                           ("mit_b0", "msdeform_pixel_decoder")])
def test_band_split_raises_for_other_backbones_and_necks_naming_f7d(backbone, neck, request):
    """What ROADMAP F7d named, the band split runs now. Swin and MiT with
    the MSDeformAttn decoder (F7d part 3): over 2 bands of 64x96 each rank
    gets its band of each level, the whole forward's rows within LEVEL_REL,
    having gathered only the encoder's value maps (and MiT its reduced
    keys). The RFP backbones (part 4; no neck: `build_neck` gives None for
    them, whatever `neck` says): over 2 bands of 64x96 each rank gets its
    band of each level within LEVEL_REL, the parameters' gradients summed
    over the ranks within HALO_GRAD_REL (DetectoRS in fp64,
    `torch_port_common.RFP_DTYPES`; it takes no image gradient, its stem
    cut from the graph; the RFP Swin's within HALO_GRAD_REL), nothing
    gathered (`tests/test_torch_port_model_axis_rfp.py` holds them
    further)."""
    if neck == "msdeform_pixel_decoder":
        whole, ranks = request.getfixturevalue("runs")["bands"][(f"{backbone}+decoder",
                                                                 DECODER_CASE)]
        for i, want in enumerate(whole["levels"]):
            scale = float(want.abs().max())
            assert [r["rows"][i] for r in ranks] == [(0, want.shape[1] // 2),
                                                     (want.shape[1] // 2, want.shape[1])]
            for r in ranks:
                a, b = r["rows"][i]
                assert float((r["levels"][i] - want[:, a:b]).abs().max()) <= LEVEL_REL * scale
        assert [r["inputs"] for r in ranks] == [[(1, 32, 96, 3)]] * 2
        decoder = dp_check.decoder_gather_bytes((64, 96), 2, 1, 6)
        assert all(r["comm"]["gather"] == decoder if backbone == "swin_tiny" else
                   r["comm"]["gather"] > decoder for r in ranks)
        return
    assert build_neck(neck, build_backbone(backbone)) is None
    whole, ranks = request.getfixturevalue("runs")["bands"][(backbone, DECODER_CASE)]
    assert (whole["grad_img"] is None) == backbone.startswith("detectors")
    assert_rfp_bands(whole, ranks, LEVEL_REL, HALO_GRAD_REL)
    assert [r["inputs"] for r in ranks] == [[(1, 32, 96, 3)]] * 2


@pytest.mark.parametrize("name", BACKBONES)
def test_band_split_raises_for_a_height_not_a_multiple_of_32(name):
    """A height that is not a multiple of 32 splits where JAX's whole VPS
    step runs (176 rows over 2: 96 + 80, the last band's stride-32 row
    partial) and raises where it does not (180 rows: not a multiple of 8),
    before anything runs."""
    assert model_axis.band_units(176, 2) == [3, 3]
    bb = build_backbone(name)
    token = _fake_split()
    try:
        with pytest.raises(ValueError, match="refuses 180 image rows"):
            backbone_and_neck(bb, build_neck("fpn", bb), torch.zeros(1, 180, 64, 3))
    finally:
        model_axis._SPLIT.reset(token)


def test_band_split_raises_for_fewer_stride_32_rows_than_bands():
    bb = build_backbone("swin_tiny")
    token = _fake_split(3)
    try:
        with pytest.raises(ValueError, match="64 image rows .* do not split into 3 bands"):
            backbone_and_neck(bb, build_neck("fpn", bb), torch.zeros(1, 64, 64, 3))
    finally:
        model_axis._SPLIT.reset(token)


def test_band_split_keeps_the_data_index_drop_path_draws():
    """Under the band split every `model` rank of a data index draws that
    index's rows of the draws one process makes for the global batch."""
    full = torch.rand((2 * 2 * 3,), generator=torch.Generator().manual_seed(0))
    for d in range(2):
        for m in range(2):
            with tmesh.batch_blocks(2), mock.patch.object(tmesh, "_ACTIVE") as active:
                active.get.return_value = DataMesh(2 * d + m, 4, object(), 2)
                got = tmesh.batch_uniform(6, torch.Generator().manual_seed(0), "cpu")
            want = full.reshape(2, 2, 3)[:, d].reshape(6)
            assert torch.equal(got, want)


# ------------------------------------------------------------------ against JAX


def test_swin_band_split_losses_match_jax_sharded_step(runs):
    want, ranks = runs["jax"]
    for r in ranks:
        assert r["replayed"] == [True]
        (got,) = r["losses"]
        assert set(got) == set(want["losses"][0])
        for k, w in want["losses"][0].items():
            assert abs(got[k] - w) <= LOSS_REL * max(abs(w), 1e-6), (k, got[k], w)


def test_jax_sharded_step_agrees_with_its_unsharded_one(runs):
    """What makes the unsharded step's decisions the ones to replay: its
    losses and gradient equal the sharded step's within the tolerances
    the port is held to."""
    (want, _), whole = runs["jax"], runs["jax_whole"]
    for k, w in want["losses"][0].items():
        assert abs(whole["losses"][0][k] - w) <= LOSS_REL * max(abs(w), 1e-6), k
    for k, w in want["grads"].items():
        scale = float(np.abs(want["grads"][weight_of(k)]).max())
        assert float(np.abs(whole["grads"][k] - w).max()) <= GRAD_REL * max(scale, 1e-12), k


def test_swin_band_split_gradient_matches_jax_sharded_step(runs):
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


def test_swin_band_split_state_matches_jax_sharded_step(runs):
    """The parameters after the step against JAX's; every rank's state the
    same, bit for bit."""
    want, ranks = runs["jax"]
    got = state_dict_to_flax(runs["model"], ranks[0]["state"])
    for k, w in want["params"].items():
        assert rel_err(got[k], w) <= STATS_REL, k
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_the_jax_case_reaches_what_it_checks(runs):
    """Each rank's backbone took its band of [ref; key] (96 and 64 rows);
    the windows exchanged rows across the band edge and through the ring:
    stages 1 and 2 shift, and their last shifted window wraps from the
    bottom band to the top one."""
    _, ranks = runs["jax"]
    assert [r["inputs"] for r in ranks] == [[(2, 96, 96, 3)], [(2, 64, 96, 3)]]
    for r in ranks:
        comm = r["comm"][0]
        assert comm["halo"] > 0 and comm["ring"] > 0 and comm["reduce"] > 0
        assert comm["gather"] == 0  # the heads run on the band: nothing gathers
    for stride in (4, 8):
        h, ws = HW[0] // stride, 7
        hp = -(-h // ws) * ws
        bands = ((0, 3 * 32 // stride), (3 * 32 // stride, h))
        need, ring, _, _ = window_plan(bands, hp, ws, ws // 2)
        assert hp - h < 4 and min(hp, -(-HW[1] // stride // ws) * ws) > ws
        assert set(range(3)) <= ring[1] and set(range(3)) <= set(need[1])  # rank 0's top rows
        assert h - 1 in ring[0] and h - 1 in need[0]  # rank 1's bottom row


# ------------------------------------------------------------------ against the port


@pytest.mark.parametrize("name", BACKBONES)
@pytest.mark.parametrize("case", list(BANDS))
def test_band_split_matches_the_whole_forward(runs, name, case):
    n_model, hw = BANDS[case]
    whole, ranks = runs["bands"][(name, case)]
    for i, want in enumerate(whole["levels"]):
        scale = float(want.abs().max())
        for r in ranks:  # each rank's band of the level, no gather
            a, b = r["rows"][i]
            got = r["levels"][i]
            assert float((got - want[:, a:b]).abs().max()) <= LEVEL_REL * scale, (case, i)
        assert ranks[0]["rows"][i][0] == 0 and ranks[-1]["rows"][i][1] == want.shape[1]
    grad = sum(r["grad_img"] for r in ranks)
    assert rel_err(grad.numpy(), whole["grad_img"].numpy()) <= HALO_GRAD_REL
    assert set(whole["grads"]) == set(ranks[0]["grads"])
    for k, g in whole["grads"].items():
        got = sum(r["grads"][k] for r in ranks)
        assert float((got - g).abs().max()) <= HALO_GRAD_REL * float(g.abs().max()), (case, k)
    units = model_axis.band_units(hw[0], n_model)
    assert [r["inputs"] for r in ranks] == [[(1, 32 * u, hw[1], 3)] for u in units]
    # MiT gathers its spatially reduced keys and values; Swin nothing
    assert all(r["comm"]["halo"] > 0 and (r["comm"]["gather"] > 0) == (name == "mit_b0")
               for r in ranks)
    if name == "mit_b0":
        assert all(r["comm"]["ring"] == 0 for r in ranks)


def test_shifted_windows_wrap_from_the_last_band_to_the_first(runs):
    """At 160 rows over 2 bands Swin's stage 1 (40 rows padded to 42, six
    windows) and stage 2 (20 padded to 21) shift, and their last shifted
    window holds the map's last real rows and its first three: the two
    bands lend each other those rows through the ring, whose bytes each
    rank counts, and the levels still match the whole forward."""
    _, ranks = runs["bands"][("swin_tiny", "160_rows_over_2")]
    assert all(r["comm"]["ring"] > 0 for r in ranks)
    need, ring, wins, own = window_plan(((0, 24), (24, 40)), 42, 7, 3)
    assert wins == ((0, 1, 2, 5), (3, 4, 5))
    assert need[0][-7:] == (38, 39, 40, 41, 0, 1, 2)  # rows 40-41 are the padding
    assert ring == (frozenset({38, 39, 40, 41, 0, 1, 2}),) * 2
    assert [need[0][p] for p in own[0]] == list(range(24))
    assert [need[1][p] for p in own[1]] == list(range(24, 40))


def test_swin_drop_path_band_split_equals_one_process(runs):
    """Swin-tiny VPS at drop-path rate 0.3, 160x96 over 2 bands (96 + 64
    rows), one step: each rank against the one-process step, every rank of
    the data index drawing the one-process run's keep values."""
    one, ranks = runs["drop_path"]
    assert [r["inputs"] for r in ranks] == [[(2, 96, 96, 3)], [(2, 64, 96, 3)]]
    for r in ranks:
        assert r["replayed"] == [True]
        for got, want in zip(r["losses"], one["losses"]):
            for k, w in want.items():
                assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)
        assert set(r["grads"]) == set(one["grads"])
        for k, g in one["grads"].items():
            scale = float(g.abs().max())
            if k.endswith(".key.bias"):  # zero up to rounding
                scale = float(one["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((r["grads"][k] - g).abs().max()) <= 1e-3 * max(scale, 1e-12), k
