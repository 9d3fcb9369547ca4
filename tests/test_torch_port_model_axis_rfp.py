"""The DetectoRS / RFP backbones on the bands of the mesh's `model` axis
(`models/rfp.py` under `parallel/model_axis.py`'s band split), against the
JAX package and against the port in one process.

On a band SAC's two global means are the band's sums, summed over the
`model` group, over the whole map's pixels; its 5x5 average pool and its
3x3 convs at dilation 1 and 3 read the 2, 1 and 3 rows their windows reach
past the band from the other bands (`model_axis.window_rows`); DetectoRS's
stem pool is ResNet's banded one; the RFP Swin pads and shifts its windows
by the whole map's height. Nothing of the RFP gathers: the feedback of FPN
level s into stage s + 1 is the band's own rows.

(a) Against JAX's modules (weights: the port's seeded init with the leaves
the reference initializes at zero, `rfp_conv` and `weight_diff`, drawn
nonzero, carried to flax by `state_dict_to_flax`, norms perturbed:
`torch_port_common.shared_weights`): SAC at stride 1 (on a stride-8 map)
and 2 (stride 4 to 8) and a SAC + RFP bottleneck (stride 2, with its RFP
feature; the ranks replay JAX's ReLU decisions) on 2 bands of an image of
72x96 (64 + 8 rows: the last band holds one row at the output stride) and
of 160x96 (96 + 64); each rank's rows of the output within LEVEL_REL of
JAX's output's largest magnitude, the inputs' gradients (the bands' rows)
and the parameters' (summed over the ranks) within HALO_GRAD_REL of each
one's largest magnitude.

(b) Against the port's one-process forward (`dp_check.pyramid_share`, the
whole forward's ReLU decisions replayed): `detectors_r50` at 72x96 over 2
(64 + 8: one row at strides 8-32) and at 96x96 over 3 (one stride-32 row a
band: the stage-4 SACs' dilation-3 windows reach two bands away), in fp64
(`torch_port_common.RFP_DTYPES` says why), and `swin_tiny_rfp` at 120x96
over 2 (64 + 56) in fp32. Each rank's band of each level within
LEVEL_REL of the level's largest magnitude, the parameters' gradients
summed over the ranks within HALO_GRAD_REL; the image's gradient absent on
both sides for DetectoRS (its stem is cut from the graph, as the
reference's `frozen_stages=1` cuts it) and within HALO_GRAD_REL for the
Swin; 0 bytes gathered; the bytes reduced exactly SAC's context sums
(`dp_check.sac_reduces`: 52 all-reduces forward and 52 back for DetectoRS
R-50's 13 SACs over two passes, none for the Swin).

(c) Against JAX's step: the one-stage Swin-tiny-RFP VPS step
(`train_check.swin_check_cfg` with `backbone="swin_tiny_rfp"`, the heads
on the RFP's 256-wide levels) over 2 gloo ranks on a 1x2 mesh against
JAX's `make_sharded_train_step` on 2 virtual CPU devices at 160x96 (the
height at which JAX's sharded Swin-tiny step agrees with its unsharded
one, `tests/test_torch_port_model_axis_swin.py`; bands of 96 + 64), JAX's
sharded step held against its unsharded one too, the ranks replaying the
unsharded step's ReLU decisions and mask-pool binarizations: the losses
within LOSS_REL, the gradient within GRAD_REL of each leaf's largest
magnitude, the parameters after the step within STATS_REL.

(d) Against the port's one-process step: the one-stage `detectors_r50` VPS
step (`VideoKNetConfig(max_insts=4)`'s 256-wide heads) at 144x96 over 2
(96 + 48 rows), the ranks replaying its ReLU decisions: the losses within
LOSS_REL, the gradient within GRAD_REL of each leaf's largest magnitude;
the stem and layer1 take no gradient on any rank, and the step's DDP looks
for them (`leaves_parameters_unused`). A JAX DetectoRS VPS step, sharded
or not, takes too long to compile here; its modules are held to JAX by
(a) and by `tests/test_torch_port_rfp.py`.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import trained_golden_common as jtg
from flax import traverse_util
from torch_port_common import (
    RFP_DTYPES,
    _collect,
    _send_spec,
    _spawn,
    assert_rfp_bands,
    jax_relu_decisions,
    perturbed_variables,
    rel_err,
    relu_call_order,
    rfp_pyramid_case,
    seeded_inputs,
    seeded_rfp,
    shared_weights,
    weight_of,
)

import video_knet_tpu_torch.config as tconfig
from video_knet_tpu.models import rfp as jrfp
from video_knet_tpu_torch.models import rfp
from video_knet_tpu_torch.models.backbones import backbone_and_neck, build_backbone
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.train_check import (
    draw_zero_init_leaves,
    swin_check_cfg,
)
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.utils.convert import load_flax_variables, state_dict_to_flax

JAX_HW = (160, 96)  # 5 stride-32 rows: bands of 96 + 64
STEP_HW = (144, 96)  # 5 stride-32 rows, the last half: bands of 96 + 48
ONE_STAGE = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
# tests/test_torch_port_model_axis.py's tolerances against a whole step
LOSS_REL = 5e-4
STATS_REL = 1e-4
GRAD_REL = 1e-3
# the band split against a whole forward
LEVEL_REL, HALO_GRAD_REL = 1e-5, 1e-4
PIECE_HW = (72, 96), (160, 96)  # the modules' images, over 2 bands
PIECES = ("sac_stride_1", "sac_stride_2", "sac_rfp_bottleneck")
PYRAMIDS = {"detectors_r50_72x96_over_2": ("detectors_r50", 2, (72, 96)),
            "detectors_r50_96x96_over_3": ("detectors_r50", 3, (96, 96)),
            "swin_tiny_rfp_120x96_over_2": ("swin_tiny_rfp", 2, (120, 96))}
RFP_BACKBONES = ("detectors_r50", "detectors_r101", "swin_b_rfp", "swin_base_rfp",
                 "swin_t_rfp", "swin_tiny_rfp")
NICE = 19  # the port's processes yield the cores to the JAX jobs while these compile


def _swin_rfp_cfgs():
    """The Swin-tiny-RFP VPS check config, one stage: (JAX's, the port's)."""
    return tuple(dataclasses.replace(swin_check_cfg(m.tiny_cfg()), backbone="swin_tiny_rfp",
                                     **ONE_STAGE) for m in (jtg, tg))


def _detectors_cfg():
    return tconfig.VideoKNetConfig(max_insts=4, backbone="detectors_r50", **ONE_STAGE)


# ------------------------------------------------------------------ (a) the modules


def _piece(name: str, hw) -> tuple[dict, dict]:
    """(the port's case for `dp_check.rfp_pieces`, JAX's whole-map output
    and gradients) of module `name` on an image of `hw`."""
    h, w = hw
    s4, s8 = (-(-h // 4), -(-w // 4)), (-(-h // 8), -(-w // 8))
    seed = PIECES.index(name) + h
    if name == "sac_rfp_bottleneck":
        args, kwargs = (32, 8), dict(stride=2, with_sac=True, with_rfp=True, rfp_channels=16)
        jmod = jrfp.DetectoRSBottleneck(features=8, stride=2, with_sac=True, with_rfp=True)
        *inputs, cot = seeded_inputs(seed, (1, *s4, 32), (1, *s8, 16), (1, *s8, 32))
    else:
        stride = int(name[-1])
        args, kwargs = (8, 12, stride), {}
        jmod = jrfp.SAConv(features=12, stride=stride)
        *inputs, cot = seeded_inputs(seed, (1, *(s8 if stride == 1 else s4), 8), (1, *s8, 12))
    port = getattr(rfp, "DetectoRSBottleneck" if kwargs else "SAConv")(*args, **kwargs)
    variables = shared_weights(port, jmod, *map(jnp.asarray, inputs), seed=seed)

    def loss(params, *xs):
        out, state = jmod.apply({**variables, "params": params}, *xs, mutable=["intermediates"],
                                capture_intermediates=lambda m, _: m.name in ("bn1", "bn2"))
        return jnp.sum(out * cot), (out, state.get("intermediates", {}))

    (_, (out, inter)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True))(
        variables["params"], *map(jnp.asarray, inputs))
    relus = []
    if kwargs:  # bn1, bn2, then the block's output: relu(z) > 0 exactly where z > 0
        relus = [torch.from_numpy(np.asarray(v) > 0) for v in (
            inter["bn1"]["__call__"][0], inter["bn2"]["__call__"][0], out)]
    want = dict(out=np.asarray(out), grad_inputs=[np.asarray(g) for g in grads[1:]],
                grads={f"params/{'/'.join(k)}": np.asarray(v)
                       for k, v in traverse_util.flatten_dict(grads[0]).items()}, port=port)
    case = dict(module=(type(port).__name__, args, kwargs), weights=port.state_dict(),
                inputs=[torch.from_numpy(x) for x in inputs], cot=torch.from_numpy(cot),
                relus=relus)
    return case, want


# ------------------------------------------------------------------ (b) the pyramids


# ------------------------------------------------------------------ the runs


@pytest.fixture(scope="module", autouse=True)
def jax_jobs(tmp_path_factory):
    """JAX's sharded step and its unsharded one, started with the file:
    they import (and later trace and compile, the longest work here) while
    the tests that need no run go first; then `runs` sends their specs."""
    root = str(tmp_path_factory.mktemp("model_axis_rfp"))
    jobs = {tag: _spawn(root, f"rfp_{tag}", None, nice=0, devices=devices)
            for tag, devices in (("sharded", 2), ("whole", 1))}
    yield root, jobs
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(jax_jobs):
    """JAX's two Swin-RFP steps in processes of their own, then the port's
    ranks replaying the unsharded step's decisions; meanwhile the DetectoRS
    step (its one-process run, then its ranks) and the band cases (the
    modules' and the pyramids' over 2 ranks in one launch, then the 3-rank
    pyramid), each in processes of their own, and here JAX's modules and
    the whole pyramids."""
    root, jobs = jax_jobs
    pool = concurrent.futures.ThreadPoolExecutor(4)
    try:
        jcfg, cfg = _swin_rfp_cfgs()
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            draw_zero_init_leaves(model, torch.Generator().manual_seed(1))
        variables = perturbed_variables(model, seed=1)
        batch = tvps.make_synthetic_batch(cfg, 1, JAX_HW, seed=0, device="cpu")
        for tag, n_model in (("sharded", 2), ("whole", 1)):
            _send_spec(root, f"rfp_{tag}", dict(
                job="sharded_vps", cfg=jcfg, variables=variables, n_data=1, n_model=n_model,
                batches=[(batch.img.numpy(), batch.ref_img.numpy(),
                          [x.numpy() for x in batch.gt], [x.numpy() for x in batch.ref_gt])]))

        def step():
            spec = dict(kind="vps", cfg=_detectors_cfg(), seed=0, n_model=2, batches=[
                tvps.make_synthetic_batch(_detectors_cfg(), 1, STEP_HW, seed=0, device="cpu")])
            tmp = os.path.join(root, "step")
            one, relus = dp_check.run_reference([spec], tmp, nice=NICE)[0]
            return one, [r[0] for r in dp_check.run_ranks(2, [{**spec, "relus": relus}], tmp,
                                                           nice=NICE)]

        futures = {"step": pool.submit(step)}

        def jax_then_ranks():
            """The port's 2 ranks, started at once (they build the model
            while JAX compiles), replaying the ReLU decisions and mask-pool
            binarizations of JAX's unsharded step in the port's call order,
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
            spec = dict(kind="vps", cfg=cfg, seed=0, n_model=2, batches=[batch], relus=relus,
                        pools=pools, weights=weights)
            ranks = dp_check.run_ranks(2, [spec], tmp, threads=2, nice=NICE,
                                       while_running=decisions)
            return got["want"], [r[0] for r in ranks], got["whole"]

        futures["jax"] = pool.submit(jax_then_ranks)
        backbones = {name: seeded_rfp(name) for name in {c[0] for c in PYRAMIDS.values()}}
        cases = {c: rfp_pyramid_case(backbones[PYRAMIDS[c][0]], *PYRAMIDS[c]) for c in PYRAMIDS}

        def bands(pieces):
            """The 2-rank cases in one launch, then the 3-rank one."""
            two = [c for c in cases if PYRAMIDS[c][1] == 2]
            got = dp_check.run_ranks(2, [cases[c][0] for c in two] + [
                dict(kind="rfp_pieces", n_model=2, hw=hw, cases=[
                    pieces[(name, hw)][0] for name in PIECES]) for hw in PIECE_HW],
                os.path.join(root, "bands_2"), nice=NICE)
            out = {c: (cases[c][1], [r[i] for r in got]) for i, c in enumerate(two)}
            for j, hw in enumerate(PIECE_HW):
                for k, name in enumerate(PIECES):
                    out[(name, hw)] = (pieces[(name, hw)][1],
                                       [r[len(two) + j][k] for r in got])
            three = [c for c in cases if PYRAMIDS[c][1] == 3]
            got = dp_check.run_ranks(3, [cases[c][0] for c in three],
                                     os.path.join(root, "bands_3"), nice=NICE)
            out.update({c: (cases[c][1], [r[i] for r in got]) for i, c in enumerate(three)})
            return out

        pieces = {(name, hw): _piece(name, hw) for hw in PIECE_HW for name in PIECES}
        futures["bands"] = pool.submit(bands, pieces)
        out = {tag: f.result() for tag, f in futures.items()}
        *out["jax"], out["jax_whole"] = out["jax"]
        return dict(**out, model=model)
    finally:
        pool.shutdown(wait=True)


# ------------------------------------------------------------------ no run needed


@pytest.mark.parametrize("name", RFP_BACKBONES)
def test_every_rfp_backbone_reaches_the_band_split(name):
    """No backbone is refused: each RFP backbone, which has no neck, goes
    on to the split's geometry, which refuses 180 rows (not a multiple of
    8) as it does for ResNet, before anything runs."""
    backbone = build_backbone(name)
    assert isinstance(backbone, rfp.RFP)
    token = model_axis._SPLIT.set(model_axis.Split("rows", None, 0, 2))
    try:
        with pytest.raises(ValueError, match="refuses 180 image rows"):
            backbone_and_neck(backbone, None, torch.zeros(1, 180, 64, 3))
    finally:
        model_axis._SPLIT.reset(token)


def test_a_dilated_window_reaches_two_bands_away():
    """96 rows over 3: one stride-32 row a band. A stage-4 SAC's dilation-3
    conv reads 7 rows a window (3 of zero padding on either side), so the
    top band's row takes the bottom band's, past its neighbour, and
    `fetch_rows` serves it from that rank."""
    band = model_axis.Split("rows", None, 0, 3, tuple(model_axis.band_units(96, 3)),
                            image=(96, 96))
    bands = model_axis.level_bands(1, 3, band)
    assert bands == ((0, 1), (1, 2), (2, 3))
    need = tuple(tuple(range(a - 3, a + 4)) for a, _ in bands)
    plan = model_axis._plan(need, tuple(frozenset() for _ in need), bands, 0)
    # [its own row, the fill row, rank 0's, 1's and 2's lent rows]: rows
    # -3..-1 and 3 are the fill, 1 and 2 the lent rows of ranks 1 and 2
    assert plan.lend_len == 1 and plan.source == (1, 1, 1, 0, 3, 4, 1)
    assert plan.lend == (0,) and plan.borrowed == (4, 5)


def test_the_stride_2_sacs_start_every_band_on_an_even_row():
    """`window_rows` needs a stride-2 window to start on each band's first
    row: at 376x1248 over 2 (192 + 184) the SAC inputs at strides 4, 8 and
    16 start their second band on rows 48, 24 and 12."""
    band = model_axis.Split("rows", None, 1, 2, tuple(model_axis.band_units(376, 2)),
                            image=(376, 1248))
    starts = [model_axis.map_bands(band, -(-1248 // s))[1][0] for s in (4, 8, 16)]
    assert starts == [48, 24, 12] and all(a % 2 == 0 for a in starts)


# ------------------------------------------------------------------ (a) against JAX's modules


@pytest.mark.parametrize("hw", PIECE_HW, ids=[f"{h}x{w}" for h, w in PIECE_HW])
@pytest.mark.parametrize("name", PIECES)
def test_rfp_modules_on_bands_match_jax(runs, name, hw):
    """Each rank's rows of the output at stride 8 (72 rows: 8 + 1; 160
    rows: 12 + 8)."""
    want, ranks = runs["bands"][(name, hw)]
    first = 4 * model_axis.band_units(hw[0], 2)[0]
    assert [r["rows"] for r in ranks] == [(0, first), (first, -(-hw[0] // 8))]
    scale = float(np.abs(want["out"]).max())
    for r in ranks:
        a, b = r["rows"]
        assert r["replayed"]
        assert float(np.abs(r["out"].numpy() - want["out"][:, a:b]).max()) <= LEVEL_REL * scale
    for i, w in enumerate(want["grad_inputs"]):
        got = torch.cat([r["grad_inputs"][i] for r in ranks], 1).numpy()
        assert rel_err(got, w) <= HALO_GRAD_REL, (name, i)
    port = want["port"]
    grads = state_dict_to_flax(port, {n: sum(r["grads"][n] for r in ranks)
                                      for n, _ in port.named_parameters()})
    assert set(grads) == set(want["grads"])
    for k, w in want["grads"].items():
        assert rel_err(grads[k], w) <= HALO_GRAD_REL, (name, k)
    assert np.abs(want["grads"][[k for k in want["grads"] if "weight_diff" in k][0]]).max() > 0
    # the windows' rows, the context's sums (as reckoned), nothing gathered
    reduced = dp_check.sac_reduces(port, 1)[1]
    for r in ranks:
        assert r["comm"]["halo"] > 0 and r["comm"]["gather"] == 0
        assert r["comm"]["reduce"] == reduced > 0


# ------------------------------------------------------------------ (b) the pyramids


@pytest.mark.parametrize("case", list(PYRAMIDS))
def test_rfp_pyramid_bands_match_the_whole_forward(runs, case):
    name, n_model, hw = PYRAMIDS[case]
    whole, ranks = runs["bands"][case]
    assert (whole["grad_img"] is None) == name.startswith("detectors")
    assert_rfp_bands(whole, ranks, LEVEL_REL, HALO_GRAD_REL)
    units = model_axis.band_units(hw[0], n_model)
    assert [r["inputs"] for r in ranks] == [[(1, min(32 * sum(units[:i + 1]), hw[0])
                                              - 32 * sum(units[:i]), hw[1], 3)]
                                            for i in range(n_model)]
    # SAC's context sums, and nothing else, reduce over the group: 52 sums
    # forward and 52 back for DetectoRS R-50's two passes, none for the Swin
    count, reduced = dp_check.sac_reduces(build_backbone(name), 1)
    assert count == (104 if name.startswith("detectors") else 0)
    assert all(r["comm"]["reduce"] * 4 == reduced * RFP_DTYPES[name].itemsize for r in ranks)


# ------------------------------------------------------------------ (c) against JAX's step


def test_jax_sharded_swin_rfp_step_agrees_with_its_unsharded_one(runs):
    """Why the port is held to the sharded step: its losses and gradient
    equal the unsharded step's within the tolerances the port is held to."""
    (want, _), whole = runs["jax"], runs["jax_whole"]
    for k, w in want["losses"][0].items():
        assert abs(whole["losses"][0][k] - w) <= LOSS_REL * max(abs(w), 1e-6), k
    for k, w in want["grads"].items():
        scale = float(np.abs(want["grads"][weight_of(k)]).max())
        assert float(np.abs(whole["grads"][k] - w).max()) <= GRAD_REL * max(scale, 1e-12), k


def test_swin_rfp_band_split_losses_match_jax_sharded_step(runs):
    want, ranks = runs["jax"]
    for r in ranks:
        assert r["replayed"] == [True]
        (got,) = r["losses"]
        assert set(got) == set(want["losses"][0])
        for k, w in want["losses"][0].items():
            assert abs(got[k] - w) <= LOSS_REL * max(abs(w), 1e-6), (k, got[k], w)


def test_swin_rfp_band_split_gradient_matches_jax_sharded_step(runs):
    """The first step's gradient on every rank (summed over the two bands:
    the replicated heads counted once) against JAX's, leaf by leaf; the
    feedback convs and the fusion among the leaves that moved."""
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
    for leaf in ("bb/rfp_conv1", "bb/rfp_conv3", "fusion_weight0", "fusion_weight3"):
        assert float(np.abs(want["grads"][f"params/backbone/{leaf}/kernel"]).max()) > 0, leaf


def test_swin_rfp_band_split_state_matches_jax_sharded_step(runs):
    """The parameters after the step against JAX's; every rank's state the
    same, bit for bit."""
    want, ranks = runs["jax"]
    got = state_dict_to_flax(runs["model"], ranks[0]["state"])
    for k, w in want["params"].items():
        assert rel_err(got[k], w) <= STATS_REL, k
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_the_swin_rfp_step_reaches_what_it_checks(runs):
    """Each rank's backbone took its band of [ref; key] (96 and 64 rows),
    exchanged rows across the band edge and gathered nothing."""
    _, ranks = runs["jax"]
    assert [r["inputs"] for r in ranks] == [[(2, 96, 96, 3)], [(2, 64, 96, 3)]]
    for r in ranks:
        comm = r["comm"][0]
        assert comm["halo"] > 0 and comm["reduce"] > 0 and comm["gather"] == 0


# ------------------------------------------------------------------ (d) the DetectoRS step


def test_detectors_step_on_bands_equals_one_process(runs):
    """One-stage DetectoRS R-50 VPS at 144x96 over 2 bands (96 + 48 rows),
    one step: each rank against the one-process step, replaying its ReLU
    decisions; 0 bytes gathered."""
    one, ranks = runs["step"]
    assert [r["inputs"] for r in ranks] == [[(2, 96, 96, 3)], [(2, 48, 96, 3)]]
    for r in ranks:
        assert r["replayed"] == [True]
        for k, w in one["losses"][0].items():
            got = r["losses"][0][k]
            assert abs(got - w) <= LOSS_REL * max(abs(w), 1e-6), (k, got, w)
        assert set(r["grads"]) == set(one["grads"])
        for k, g in one["grads"].items():
            scale = float(g.abs().max())
            if k.endswith(".key.bias"):  # zero up to rounding
                scale = float(one["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((r["grads"][k] - g).abs().max()) <= GRAD_REL * max(scale, 1e-12), k
        comm = r["comm"][0]
        assert comm["gather"] == 0 and comm["halo"] > 0 and comm["reduce"] > 0


def test_detectors_step_leaves_the_cut_stem_to_ddp(runs):
    """The DetectoRS stem and layer1 take no gradient (their activations
    are cut); the model says so, so the step's DDP over the `model` axis
    looks for unused parameters as the `data` axis's does, and their
    parameters stay trainable (the reference's optimizer decays them)."""
    one, ranks = runs["step"]
    for r in (one, *ranks):
        assert r["declares_unused"]
        assert not any(k.startswith(("backbone.bb.conv1.", "backbone.bb.layer1_"))
                       for k in r["grads"])
        assert "backbone.bb.conv1.weight" in r["trainable"]
        assert any(k.startswith("backbone.bb.layer4_block0.sac.") for k in r["grads"])
