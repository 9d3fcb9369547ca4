"""The mesh's `model` axis of the port on the CPU (`parallel/model_axis.py`):
VPS spatial sharding of ResNet + FPN over image rows and VIS clip
parallelism over frames, against the JAX package and against the port in
one process.

Against JAX (its sharded steps in processes of their own, 4 virtual CPU
devices each, `tests/torch_port_jax_jobs.py`), the port over 4 gloo ranks
on a 2x2 mesh (rank r at (d, m) = divmod(r, 2), `tools/dp_check.py`), each
rank replaying JAX's ReLU decisions on its rows and its band or frames
(`model_axis.local_share`):
- `make_sharded_train_step` with the image height sharded over `model`:
  the one-stage R-50 `VideoKNetConfig(max_insts=4, norm_eval=False)` at
  128x96 (VPS_HW), global batch 2, data index 1's pair free of positives
  (a loss normalizer summed over the world instead of the `data` axis
  would count data index 0's positives twice). One step: the losses within LOSS_REL,
  the gradient (each rank's, summed over the world by DDP) within GRAD_REL
  of each leaf's largest magnitude, the live BatchNorm statistics within
  STATS_REL. The case is live BatchNorm throughout: its moments span every
  rank, the reduction a band split changes.
- `make_sharded_vis_train_step` with the frames sharded over `model`:
  JAX's own case (`tests/test_parallel.py:67-85`: `tiny_vis_cfg`, T=2,
  B=2), cut to one per-frame and one clip stage (each JAX compile costs
  ~40 s here); the same checks.

Against the port in one process (`dp_check.run_reference`, whose ReLU
decisions the ranks replay): Swin-tiny VIS (`train_check.vis_check_cfg`)
at drop-path rate 0.3 with clips of 5 frames over 2 ranks (3 + 2: uneven
shares, each rank keeping its frames' draws of the global batch), one
step: losses within 1e-4, the gradient within 1e-3, every parameter
within 1e-6.

The band split alone: ResNet-50 + FPN over 2 bands at 64x96 and 4 bands at
128x192 (`dp_check.pyramid_share`) against the whole forward in this
process: each rank's band of each level (nothing gathered) within 1e-5 of
the whole level's largest magnitude, the image's and the parameters'
gradients (summed over the ranks) within 1e-4; each rank's backbone took
its band, H / n_model rows; ResNet-50 + the MSDeformAttn decoder and
DetectoRS R-50 over 2 bands at 64x96 likewise. Also: the mesh's layout
and shards against JAX's `make_mesh` at 1x2, 2x2 and 4x2, and what raises.
"""

import concurrent.futures
import dataclasses
import os
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_common import (
    _collect,
    _send_spec,
    _spawn,
    assert_rfp_bands,
    jax_relu_decisions,
    no_positives,
    perturbed_variables,
    rel_err,
    relu_call_order,
    rfp_pyramid_case,
    seeded_rfp,
    weight_of,
)

import video_knet_tpu.config as jconfig
import video_knet_tpu.config_vis as jconfig_vis
import video_knet_tpu.parallel.mesh as jmesh
import video_knet_tpu_torch.config as tconfig
import video_knet_tpu_torch.config_vis as tconfig_vis
from tests.test_vis import tiny_vis_cfg
from video_knet_tpu_torch.models.backbones import backbone_and_neck, build_backbone, build_neck
from video_knet_tpu_torch.models.layers import init_parameters
from video_knet_tpu_torch.models.resnet import FPN, ResNet
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
from video_knet_tpu_torch.parallel import mesh as tmesh
from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.parallel.mesh import DataMesh
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools.train_check import (
    relu_pattern,
    spread_sampling_offsets,
    vis_check_cfg,
)
from video_knet_tpu_torch.train import image as timage
from video_knet_tpu_torch.train import vis as tvis
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.utils.convert import load_flax_variables, state_dict_to_flax

HW = (64, 96)
# the VPS case against JAX: at 64x96 a band of the 2x2 mesh is one row at
# stride 32, and there JAX's spatially sharded step (XLA's partitioning on
# the virtual CPU devices) gives another ResNet-50 gradient than its
# unsharded step, its forward the same; from 128 rows on the two agree
VPS_HW = (128, 96)
ONE_STAGE = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
ONE_TRACKER_STAGE = dict(tracker_num_stages=1, tracker_assign_stages=1,
                         tracker_stage_loss_weights=(1.0,))
# tests/test_torch_port_parallel.py's tolerances for this one-stage R-50 at
# 64x96 against JAX (live statistics from few values a channel)
LOSS_REL = 5e-4
STATS_REL = 1e-4
GRAD_REL = 1e-3
# the band split against the whole forward, in the port
LEVEL_REL, HALO_GRAD_REL = 1e-5, 1e-4
BANDS = {"2_bands_64x96": (2, (64, 96)), "4_bands_128x192": (4, (128, 192))}
RANKS = 4  # the 2x2 mesh
NICE = 19  # the port's processes yield the cores to the JAX jobs while these compile


def _vis_cfgs():
    """`tests/test_vis.py:tiny_vis_cfg` of either package, cut to one
    per-frame and one clip stage: (JAX's, the port's)."""
    out = []
    for cfg_mod, vis_mod in ((jconfig, jconfig_vis), (tconfig, tconfig_vis)):
        cfg = vis_mod.VISConfig(
            num_classes=5, num_proposals=8, num_frames=2, max_insts=4,
            rpn=cfg_mod.ConvKernelHeadConfig(
                num_proposals=8, num_classes=5, num_thing_classes=5, num_stuff_classes=0,
                cat_stuff_mask=False, feat_downsample_stride=2, loss_rank_weight=0.1),
            head=cfg_mod.KernelUpdateHeadConfig(
                num_classes=5, num_thing_classes=5, num_stuff_classes=0, mask_upsample_stride=2,
                feedforward_channels=256),
            test=cfg_mod.TestCfg(max_per_img=4))
        out.append(dataclasses.replace(cfg, **ONE_STAGE, **ONE_TRACKER_STAGE))
    assert out[0] == dataclasses.replace(tiny_vis_cfg(), **ONE_STAGE, **ONE_TRACKER_STAGE)
    return out


def _vps_batch(cfg):
    """The global batch of 2 pairs, data index 1's pair free of positives."""
    b = tvps.make_synthetic_batch(cfg, 2, VPS_HW, seed=0, device="cpu")
    return b._replace(gt=no_positives(b.gt, 1), ref_gt=no_positives(b.ref_gt, 1))


def _swin_cfg():
    cfg = vis_check_cfg(tconfig_vis.VISConfig())
    return dataclasses.replace(cfg, backbone="swin_tiny", backbone_drop_path_rate=0.3,
                               num_frames=5)


def _uninitialized_pyramid():
    """ResNet-50 + FPN as built, weights uninitialized (for what raises
    before it computes)."""
    return ResNet(50), FPN((256, 512, 1024, 2048))


def _pyramid(seed: int = 0, neck_type: str = "fpn"):
    """A seeded ResNet-50 + FPN (or `neck_type`) in eval mode, statistics
    off their init (the decoder's sampling offsets reaching a few
    pixels)."""
    gen = torch.Generator().manual_seed(seed)
    backbone = ResNet(50)
    neck = build_neck(neck_type, backbone)
    init_parameters(backbone, gen)
    init_parameters(neck, gen)
    if neck_type == "msdeform_pixel_decoder":
        spread_sampling_offsets(neck, gen)
    with torch.no_grad():
        for name, buf in backbone.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=gen)
    return backbone.eval(), neck.eval()


def _whole_pyramid(backbone, neck, img, cot) -> dict:
    """The whole forward and backward, and its ReLU decisions (which the
    bands replay: an input within rounding of zero would otherwise send
    the two backwards down different sides of its kink)."""
    x = img.clone().requires_grad_(True)
    relus: list = []
    with relu_pattern(relus):
        levels = backbone_and_neck(backbone, neck, x)
    sum((lv * c).sum() for lv, c in zip(levels, cot)).backward()
    grads = {f"{tag}.{n}": p.grad.clone() for tag, m in (("backbone", backbone), ("neck", neck))
             for n, p in m.named_parameters()}
    for m in (backbone, neck):
        m.zero_grad(set_to_none=True)
    return dict(levels=[lv.detach() for lv in levels], grad_img=x.grad, grads=grads,
                relus=relus)


def _halo_case(n_model: int, hw, neck_type: str = "fpn") -> tuple[dict, dict]:
    """(the band split's spec, the whole forward and backward here)."""
    backbone, neck = _pyramid(neck_type=neck_type)
    rng = np.random.RandomState(n_model)
    img = torch.from_numpy(rng.randn(1, *hw, 3).astype(np.float32))
    cot = [torch.from_numpy(rng.randn(1, hw[0] // s, hw[1] // s, 256).astype(np.float32))
           for s in (4, 8, 16, 32)]
    whole = _whole_pyramid(backbone, neck, img, cot)
    spec = dict(kind="pyramid", n_model=n_model, backbone="resnet50", neck=neck_type, img=img,
                cotangents=cot, weights=(backbone.state_dict(), neck.state_dict()),
                relus=whole["relus"])
    return spec, whole


@pytest.fixture(scope="module", autouse=True)
def jax_jobs(tmp_path_factory):
    """JAX's two jobs, started with the file: they import (and later trace
    and compile, the longest work here) while the tests that need no run
    go first; then `runs` sends their specs."""
    root = str(tmp_path_factory.mktemp("model_axis"))
    jobs = {tag: _spawn(root, f"model_axis_{tag}", None, nice=0, devices=4)
            for tag in ("vps", "vis")}
    yield root, jobs
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(jax_jobs):
    """JAX's two sharded steps in processes of their own, then the port's
    ranks replaying their ReLU decisions; meanwhile the Swin frame split
    (its one-process run, then its ranks) and the band splits, each in
    processes of their own, and here the whole pyramids."""
    root, jobs = jax_jobs
    jobs = dict(jobs)  # `jax_then_ranks` pops each job it collects
    pool = concurrent.futures.ThreadPoolExecutor(6)
    try:
        jcfg, tcfg = (mod.VideoKNetConfig(max_insts=4, norm_eval=False, **ONE_STAGE)
                      for mod in (jconfig, tconfig))
        vps_model = VideoKNet(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
        vps_vars = perturbed_variables(vps_model, seed=1)
        vps_batch = _vps_batch(tcfg)
        _send_spec(root, "model_axis_vps", dict(
            job="sharded_vps", cfg=jcfg, variables=vps_vars, n_model=2, batches=[(
                vps_batch.img.numpy(), vps_batch.ref_img.numpy(),
                [x.numpy() for x in vps_batch.gt], [x.numpy() for x in vps_batch.ref_gt])]))
        vis_j, vis_t = _vis_cfgs()
        vis_model = KNetVIS(vis_t, generator=torch.Generator().manual_seed(2), device="cpu")
        vis_vars = perturbed_variables(vis_model, seed=3)
        vis_batch = tvis.make_synthetic_batch(vis_t, 2, HW, seed=0, device="cpu")
        _send_spec(root, "model_axis_vis", dict(
            job="sharded_vis", cfg=vis_j, variables=vis_vars, n_model=2, batches=[(
                vis_batch.clip.numpy(), [g.numpy() for g in vis_batch.gt])]))

        def swin():
            cfg = _swin_cfg()
            spec = dict(kind="vis", cfg=cfg, seed=0, n_model=2,
                        batches=[tvis.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")])
            tmp = os.path.join(root, "swin")
            one, relus = dp_check.run_reference([spec], tmp, nice=NICE)[0]
            return one, [r[0] for r in dp_check.run_ranks(2, [{**spec, "relus": relus}], tmp,
                                                           nice=NICE)]

        def bands(name):
            spec, whole = halo[name]
            return whole, [r[0] for r in dp_check.run_ranks(
                spec["n_model"], [spec], os.path.join(root, name), nice=NICE)]

        halo = {name: _halo_case(*case) for name, case in BANDS.items()}
        halo["decoder"] = _halo_case(*BANDS["2_bands_64x96"], "msdeform_pixel_decoder")
        halo["detectors_r50"] = rfp_pyramid_case(seeded_rfp("detectors_r50"), "detectors_r50",
                                                 *BANDS["2_bands_64x96"])
        futures = {"swin": pool.submit(swin),
                   **{name: pool.submit(bands, name)
                      for name in [*BANDS, "decoder", "detectors_r50"]}}

        def jax_then_ranks(tag, model, cfg, variables, batch, run):
            """The port's 4 ranks, started at once (they build the model
            while JAX compiles), replaying JAX's job's ReLU decisions in the
            port's call order, which they wait for."""
            got, tmp = {}, os.path.join(root, tag)
            relus, pools = os.path.join(tmp, "relus.pkl"), os.path.join(tmp, "pools.pkl")

            def decisions():
                with torch.no_grad():  # while JAX compiles
                    order = relu_call_order(model, lambda: run(model, batch))
                got["want"] = want = _collect(*jobs.pop(tag))
                if "pools" in want:
                    dp_check.write_relus(pools, [[torch.from_numpy(d) for d in want["pools"][0]]])
                dp_check.write_relus(relus, [jax_relu_decisions(want["relus"][0], model, None,
                                                                order)])

            weights = {k: v.clone() for k, v in load_flax_variables(
                model, variables).state_dict().items()}
            spec = dict(kind=tag, cfg=cfg, seed=0, n_model=2, batches=[batch], relus=relus,
                        weights=weights, **({"pools": pools} if tag == "vps" else {}))
            ranks = dp_check.run_ranks(RANKS, [spec], tmp, threads=2, nice=NICE,
                                       while_running=decisions)
            return got["want"], model, [r[0] for r in ranks]

        futures["vps"] = pool.submit(
            jax_then_ranks, "vps", vps_model, tcfg, vps_vars, vps_batch,
            lambda m, b: m.forward_train(b.img, b.ref_img))
        futures["vis"] = pool.submit(
            jax_then_ranks, "vis", vis_model, vis_t, vis_vars, vis_batch,
            lambda m, b: m(b.clip))
        out = {tag: f.result() for tag, f in futures.items()}
        out.update(vps_batch=vps_batch, vis_batch=vis_batch, vps_vars=vps_vars)
        return out
    finally:
        pool.shutdown(wait=True)


# ------------------------------------------------------------------ no run needed


def test_frame_split_keeps_each_frames_drop_path_draw():
    """Under the frame split each rank's draws are its frames' rows of the
    draws one process makes for the global batch."""
    clips, t = 2, 5
    full = torch.rand((2 * clips * t,), generator=torch.Generator().manual_seed(0))
    for d in range(2):
        for m, frames in enumerate(((0, 1, 2), (3, 4))):
            split = model_axis.Split("frames", None, m, 2)
            rows = model_axis.frame_rows(clips, t, split)
            with tmesh.share_rows(clips * t, rows), \
                    mock.patch.object(tmesh, "_ACTIVE") as active:
                active.get.return_value = DataMesh(2 * d + m, 4, object(), 2)
                got = tmesh.batch_uniform(len(rows), torch.Generator().manual_seed(0), "cpu")
            want = full[[d * clips * t + b * t + f for b in range(clips) for f in frames]]
            assert torch.equal(got, want)


def _fake_split(kind: str, count: int = 2):
    """A split context with no process group: what raises, raises before
    any collective."""
    return model_axis._SPLIT.set(model_axis.Split(kind, None, 0, count))


def test_band_split_raises_for_a_height_that_does_not_split():
    """Bands may be uneven (96 rows over 2: 64 + 32) and the last may hold
    a partial stride-32 row (80 over 2: 64 + 16), but the split refuses a
    height JAX's whole VPS step refuses (70 rows: not a multiple of 8) and
    one with fewer stride-32 rows than bands (64 rows over 3)."""
    backbone, neck = _uninitialized_pyramid()
    assert model_axis.band_units(96, 2) == [2, 1] and model_axis.band_units(80, 2) == [2, 1]
    for count, rows, match in ((2, 70, "refuses 70 image rows"),
                               (3, 64, "64 image rows .* do not split into 3 bands")):
        token = _fake_split("rows", count)
        try:
            with pytest.raises(ValueError, match=match):
                backbone_and_neck(backbone, neck, torch.zeros(1, rows, 64, 3))
        finally:
            model_axis._SPLIT.reset(token)


@pytest.mark.parametrize("backbone,neck", [("resnet50", "msdeform_pixel_decoder"),
                                           ("detectors_r50", "fpn")])
def test_band_split_raises_for_other_backbones_naming_f7c(backbone, neck, request):
    """What F7c left of the band split (Swin and MiT run on bands since:
    `tests/test_torch_port_model_axis_swin.py`) stood in ROADMAP F7d. Its
    part 3 put the MSDeformAttn decoder on the bands: ResNet-50 + decoder
    over 2 bands of 64x96 returns each rank's band of each level, the whole
    forward's rows within LEVEL_REL, having gathered only the encoder's
    value maps. Its part 4 put the RFP backbones on the bands, and nothing
    raises now: DetectoRS R-50 (no neck: `build_neck` gives None for it,
    whatever `neck` says) over 2 bands of 64x96 in fp64
    (`torch_port_common.RFP_DTYPES`) returns each rank's band of each level
    within LEVEL_REL, the parameters' gradients summed over the ranks within
    HALO_GRAD_REL, no image gradient on either side (its stem is cut from
    the graph), nothing gathered (`tests/test_torch_port_model_axis_rfp.py`
    holds it further)."""
    runs = request.getfixturevalue("runs")
    if neck == "msdeform_pixel_decoder":
        whole, ranks = runs["decoder"]
        for i, want in enumerate(whole["levels"]):
            scale = float(want.abs().max())
            assert [r["rows"][i] for r in ranks] == [(0, want.shape[1] // 2),
                                                     (want.shape[1] // 2, want.shape[1])]
            for r in ranks:
                a, b = r["rows"][i]
                assert float((r["levels"][i] - want[:, a:b]).abs().max()) <= LEVEL_REL * scale
        assert [r["inputs"] for r in ranks] == [[(1, 32, 96, 3)]] * 2
        assert all(r["comm"]["gather"] == dp_check.decoder_gather_bytes((64, 96), 2, 1, 6)
                   for r in ranks)
        return
    assert build_neck(neck, build_backbone(backbone)) is None
    whole, ranks = runs[backbone]
    assert whole["grad_img"] is None
    assert_rfp_bands(whole, ranks, LEVEL_REL, HALO_GRAD_REL)
    assert [r["inputs"] for r in ranks] == [[(1, 32, 96, 3)]] * 2


def test_frame_split_needs_the_clip_length():
    backbone, neck = _uninitialized_pyramid()
    token = _fake_split("frames")
    try:
        with pytest.raises(ValueError, match="clip length"):
            backbone_and_neck(backbone, neck, torch.zeros(2, 64, 64, 3))
    finally:
        model_axis._SPLIT.reset(token)
    assert model_axis.frame_counts(5, 2) == [3, 2] and model_axis.frame_counts(4, 4) == [1] * 4
    with pytest.raises(ValueError, match="a clip of 2 frames does not split over 3"):
        model_axis.frame_counts(2, 3)


# ------------------------------------------------------------------ the mesh


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2), (4, 2)])
def test_mesh_layout_and_shards_match_jax(n_data, n_model):
    """Rank r's (data, model) place is device r's in JAX's `make_mesh`, and
    its rows of every batch leaf are the shard JAX puts on that device
    (replicated over `model`)."""
    world = n_data * n_model
    devices = jax.devices()[:world]
    jm = jmesh.make_mesh(n_data=n_data, n_model=n_model, devices=devices)
    rng = np.random.RandomState(world)
    batch = (rng.randn(2 * n_data, 3, 2).astype(np.float32),
             rng.randn(2 * n_data, 5).astype(np.float32))
    want = jax.tree_util.tree_leaves(jmesh.shard_batch(jm, batch))
    for r, dev in enumerate(devices):
        mesh = DataMesh(r, world, n_model=n_model)
        assert jm.devices[mesh.data_index, mesh.model_index] == dev
        got = jax.tree_util.tree_leaves(tmesh.shard_batch(mesh, batch))
        for g, w in zip(got, want):
            shard = next(s for s in w.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(g, np.asarray(shard.data))


def test_steps_without_a_model_axis_refuse_a_mesh_with_one():
    """JAX's image step has no `model` axis, so the port's refuses a mesh
    with one (before it runs anything: the model stands in by its config);
    a mesh needs `n_model` to divide the world."""
    from torch_port_common import _tiny_image_cfg

    cfg = dataclasses.replace(_tiny_image_cfg(tconfig.KNetConfig()), **ONE_STAGE)
    state = create_train_state(types.SimpleNamespace(cfg=cfg), None,
                               DataMesh(0, 2, object(), n_model=2))
    batch = timage.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no `model` axis"):
        timage.train_step(state, batch)
    with pytest.raises(ValueError, match="does not divide"):
        DataMesh(0, 3, n_model=2)


# ------------------------------------------------------------------ against JAX


@pytest.mark.parametrize("task", ["vps", "vis"])
def test_model_axis_losses_match_jax_sharded_step(runs, task):
    want, _, ranks = runs[task]
    for r in ranks:
        assert r["replayed"] == [True]
        (got,) = r["losses"]
        assert set(got) == set(want["losses"][0])
        for k, w in want["losses"][0].items():
            assert abs(got[k] - w) <= LOSS_REL * max(abs(w), 1e-6), (task, k, got[k], w)


@pytest.mark.parametrize("task", ["vps", "vis"])
def test_model_axis_gradient_matches_jax_sharded_step(runs, task):
    """The first step's gradient on every rank (DDP's sum over the world:
    the replicated heads counted once, the backbone summed over the bands
    or frames) against JAX's, leaf by leaf."""
    want, model, ranks = runs[task]
    moved = 0
    for r in ranks:
        grads = state_dict_to_flax(model, {n: r["grads"].get(n, torch.zeros_like(p))
                                           for n, p in model.named_parameters()})
        for k, w in want["grads"].items():
            scale = float(np.abs(want["grads"][weight_of(k)]).max())
            assert float(np.abs(grads[k] - w).max()) <= GRAD_REL * max(scale, 1e-12), (task, k)
            moved += float(np.abs(w).max()) > 0
    assert moved > RANKS * len(want["grads"]) // 2


@pytest.mark.parametrize("task", ["vps", "vis"])
def test_model_axis_state_matches_jax_sharded_step(runs, task):
    """The BatchNorm statistics after the step (live: moved, from moments
    summed over every rank's band) against JAX's; every rank's state the
    same, bit for bit."""
    want, model, ranks = runs[task]
    got = state_dict_to_flax(model, ranks[0]["state"])
    for k, w in want["batch_stats"].items():
        assert rel_err(got[k], w) <= STATS_REL, (task, k)
    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k
    if task == "vps":  # live BatchNorm: the statistics past the frozen stages moved
        start = traverse_util.flatten_dict(runs["vps_vars"], sep="/")
        assert any(not np.array_equal(got[k], start[k]) for k in want["batch_stats"])


def test_the_jax_cases_reach_what_they_check(runs):
    """Data index 1's pair has no positive (its normalizers are zero: a sum
    over the world would count data index 0's twice); each rank's backbone
    took its band of its data index's pair ([ref; key]: 2 images of 64 of
    the 128 rows) or its frame of its data index's clip; the bytes each
    rank handed to the collectives, by kind."""
    b = runs["vps_batch"]
    for gt in (b.gt, b.ref_gt):
        assert not gt.valid[1].any() and not gt.sem_valid[1].any() and gt.valid[0].any()
    _, _, vps = runs["vps"]
    assert [r["inputs"] for r in vps] == [[(2, VPS_HW[0] // 2, VPS_HW[1], 3)]] * RANKS
    _, _, vis = runs["vis"]
    assert [r["inputs"] for r in vis] == [[(1, *HW, 3)]] * RANKS
    # neither split gathers the pyramid: the band split gathers nothing, its
    # heads and losses running on the band; the frame split gathers the
    # merge's per-frame kernels alone (8 proposals x 256 channels: its frame
    # forward, the clip's 2 frames' gradient back); both reduce their sums
    kernels = 4 * 8 * 256
    assert all(r["comm"][0]["gather"] == kernels * (1 + 2) and r["comm"][0]["reduce"] > 0
               for r in vis)
    assert all(r["comm"][0]["gather"] == 0 and r["comm"][0]["reduce"] > 0 for r in vps)
    assert all(r["comm"][0]["halo"] > 0 for r in vps)
    assert all(r["comm"][0]["halo"] == 0 for r in vis)


# ------------------------------------------------------------------ frames, uneven, drop path


def test_uneven_frames_with_drop_path_equal_one_process(runs):
    """Swin-tiny VIS, drop path 0.3, a clip of 5 frames over 2 ranks (3 +
    2): each rank against the one-process step."""
    one, ranks = runs["swin"]
    assert [r["inputs"] for r in ranks] == [[(3, *HW, 3)], [(2, *HW, 3)]]
    for r in ranks:
        assert r["replayed"] == [True]
        for got, want in zip(r["losses"], one["losses"]):
            for k, w in want.items():
                assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)
        for k, g in one["grads"].items():
            scale = float(g.abs().max())
            if k.endswith(".key.bias"):  # zero up to rounding
                scale = float(one["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((r["grads"][k] - g).abs().max()) <= 1e-3 * max(scale, 1e-12), k
        for k, v in one["state"].items():
            assert float((r["state"][k] - v).abs().max()) <= 1e-6, k


# ------------------------------------------------------------------ the band split alone


@pytest.mark.parametrize("case", list(BANDS))
def test_band_split_matches_the_whole_forward(runs, case):
    n_model, hw = BANDS[case]
    whole, ranks = runs[case]
    for i, want in enumerate(whole["levels"]):
        scale = float(want.abs().max())
        for r in ranks:  # each rank's band of the level, no gather
            a, b = r["rows"][i]
            got = r["levels"][i]
            assert float((got - want[:, a:b]).abs().max()) <= LEVEL_REL * scale, (case, i)
        assert [r["rows"][i] for r in ranks] == [
            (j * want.shape[1] // n_model, (j + 1) * want.shape[1] // n_model)
            for j in range(n_model)]
    grad = sum(r["grad_img"] for r in ranks)
    assert rel_err(grad.numpy(), whole["grad_img"].numpy()) <= HALO_GRAD_REL
    for k, g in whole["grads"].items():
        got = sum(r["grads"][k] for r in ranks)
        assert float((got - g).abs().max()) <= HALO_GRAD_REL * float(g.abs().max()), (case, k)
    # each rank's backbone took its band, not the image
    assert [r["inputs"] for r in ranks] == [[(1, hw[0] // n_model, hw[1], 3)]] * n_model
    assert all(r["comm"]["halo"] > 0 and r["comm"]["gather"] == 0 for r in ranks)
