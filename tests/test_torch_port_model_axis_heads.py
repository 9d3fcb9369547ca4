"""The VPS heads and loss block on the bands of the mesh's `model` axis
(`parallel/model_axis.py`): no rank gathers the pyramid; every layer after
the neck runs on the rank's band of the rows, and every sum over pixels is
the band's, summed over the `model` group.

The banded pieces (`tools/dp_check.py:band_pieces`, gloo ranks in
processes of their own) against the same code on the whole map in this
process, at 2 even bands and 4 uneven ones of a 192-row image (6 stride-32
rows: 3 + 3, and 2 + 2 + 1 + 1): GroupNorm's output and gradients,
`upsample2x`, `resize_bilinear` and `upscale_masks` (bit-equal forward),
the positional encoding (bit-equal), K1's summed partial sums and their
backward, the dice loss and its gradient, the dice and mask costs, and
every pixel-count normalizer of the loss block. Within PIECE_REL of each
result's largest magnitude (fp32 sums in another order); a gradient that a
halo returns to its owner within HALO_REL. The same bands of the port's
Semantic-FPN and kernel head, assembled, against JAX's modules on the
whole map (64 channels, each jitted once), within HEAD_REL of each
output's scale (`tests/test_torch_port_heads.py`'s tolerance).

Whole steps over the band split against one process (`dp_check.
run_reference`, whose ReLU decisions the ranks replay): R-50 VPS at 128x96
over 4 bands (one stride-32 row each), Swin-tiny VPS at 64x96 over 2, and
the MiT-b0 RoI / GT-box head (`roi_gt_box`, a consumer of the whole fused
map) at 64x96 over 2: losses within 1e-4, each gradient leaf within
1e-3 of its scale (the tolerances of the drop-path case of
`tests/test_torch_port_model_axis_swin.py`), so that each rank's loss share
and `model_sum`'s backward give every parameter its gradient once;
`BYTES["gather"]` is 0 for R-50 and Swin-tiny. Also the aligned head
(`fpn_type='upernet_align'`, R-50 at 64x96 over 2), whose warps reach anywhere in the
map: it runs on the gathered pyramid, its outputs cut to the band.
"""

import concurrent.futures
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch_port_common import perturbed_variables, port_of

import video_knet_tpu.config as jconfig
from video_knet_tpu.models.kernel_head import ConvKernelHead as JConvKernelHead
from video_knet_tpu.models.semantic_fpn import SemanticFPN as JSemanticFPN
from video_knet_tpu_torch import config as tconfig
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead
from video_knet_tpu_torch.models.layers import init_parameters
from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.parallel.mesh import DataMesh
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.train_check import swin_check_cfg, track_check_cfg
from video_knet_tpu_torch.train import vps as tvps

C = 64
H, W = 192, 96  # 6 stride-32 rows
PIECE_CASES = {"2_even_bands": 2, "4_uneven_bands": 4}
PIECE_REL, HALO_REL, HEAD_REL = 1e-6, 1e-5, 1e-4
EXACT = ("upsample2x", "resize_bilinear", "upscale_masks", "positional_encoding")
ONE_STAGE = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
LOSS_REL, GRAD_REL = 1e-4, 1e-3
STEP_CASES = {"r50_4_bands": (4, (128, 96)), "swin_tiny_2_bands": (2, (64, 96)),
              "roi_gt_box_2_bands": (2, (64, 96)), "upernet_align_2_bands": (2, (64, 96))}
WHOLE_MAP_CONSUMERS = ("roi", "upernet")  # the cases that gather


def _head_kw():
    return dict(num_proposals=8, in_channels=C, out_channels=C, fpn_feat_channels=C,
                feat_downsample_stride=4)


def _inputs(seed: int = 0) -> dict:
    """The whole-map tensors the pieces cut their bands from."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    h2, w2, h8, w8 = H // 2, W // 2, H // 8, W // 8
    rank_t = torch.from_numpy(rng.randint(0, 7, (2, h2, w2)).astype(np.int32))
    rank_t[:, :h2 // 3] = 255
    return dict(
        gn_x=f(1, h8, w8, C, scale=2.0) + 0.5, gn_cot=f(1, h8, w8, C), gn_weight=f(C) + 1.0,
        gn_bias=f(C), up_x=f(1, H // 16, W // 16, C), up_cot=f(1, h8, w8, C),
        seg_x=f(1, h8, w8, 19), seg_cot=f(1, h2, w2, 19), masks=f(2, 5, h8, w8, scale=3.0),
        masks_cot=f(2, 5, h2, w2), pe_hwc=(H // 32, W // 32, C),
        pool_logits=f(2, 7, h8, w8, scale=3.0), pool_feats=f(2, h8, w8, C),
        pool_cot=f(2, 7, C), pred=f(4, h2, w2, scale=3.0),
        tgt=(f(4, h2, w2) > 0.3).float(), w=torch.tensor([1.0, 0.0, 1.0, 1.0]),
        cost_logits=f(2, 7, h2, w2, scale=3.0), cost_gt=(f(2, 3, h2, w2) > 0.5).float(),
        seg_logits=f(2, h2, w2, 5),
        seg_labels=torch.from_numpy(rng.randint(0, 6, (2, h2, w2)).astype(np.int32)),
        rank_logits=f(2, 7, h2, w2), rank_target=rank_t)


def _pieces_spec() -> tuple[dict, dict]:
    """(the band_pieces spec, the JAX head's variables)."""
    head = ConvKernelHead(tconfig.ConvKernelHeadConfig(**_head_kw()), in_channels=C)
    init_parameters(head, torch.Generator().manual_seed(3))
    variables = perturbed_variables(head, seed=3)
    port_of(head, variables)
    rng = np.random.RandomState(1)
    levels = [torch.from_numpy(rng.randn(1, H // s, W // s, C).astype(np.float32))
              for s in (4, 8, 16, 32)]
    return dict(kind="band_pieces", height=H, inputs=_inputs(), levels=levels,
                head=(head.cfg, head.state_dict())), variables


def _step_spec(name: str) -> dict:
    n_model, hw = STEP_CASES[name]
    if name.startswith("r50"):
        cfg = tconfig.VideoKNetConfig(max_insts=4, **ONE_STAGE)
    elif name.startswith("swin"):
        cfg = dataclasses.replace(swin_check_cfg(tg.tiny_cfg()), **ONE_STAGE)
    elif name.startswith("upernet"):
        cfg = tconfig.VideoKNetConfig(max_insts=4, **ONE_STAGE)
        cfg = dataclasses.replace(cfg, rpn=dataclasses.replace(cfg.rpn, fpn_type="upernet_align"))
    else:
        cfg = dataclasses.replace(track_check_cfg(tg.tiny_cfg(), "roi_gt_box"), **ONE_STAGE)
    return dict(kind="vps", cfg=cfg, seed=0, n_model=n_model,
                batches=[tvps.make_synthetic_batch(cfg, 1, hw, seed=0, device="cpu")])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every case (2 ranks: the even pieces and the 2-band
    steps; 4: the uneven pieces and the R-50 step) and the steps'
    one-process runs, each in processes of their own, started at once: the
    ranks build their models while the reference runs, then wait for its
    ReLU decisions. Meanwhile, here: the pieces on the whole map and JAX's
    modules."""
    root = str(tmp_path_factory.mktemp("model_axis_heads"))
    pieces, variables = _pieces_spec()
    steps = {name: _step_spec(name) for name in STEP_CASES}
    relus = {name: os.path.join(root, f"{name}.relus") for name in steps}
    by_world = {w: [{**pieces, "n_model": n} for n in PIECE_CASES.values() if n == w]
                + [{**s, "relus": relus[k]} for k, s in steps.items() if s["n_model"] == w]
                for w in (2, 4)}
    pool = concurrent.futures.ThreadPoolExecutor(3)
    try:
        def reference():
            ones = dp_check.run_reference(list(steps.values()), os.path.join(root, "ref"))
            for name, (one, rec) in zip(steps, ones):
                dp_check.write_relus(relus[name], rec)
            return dict(zip(steps, (one for one, _ in ones)))

        futures = {"ref": pool.submit(reference)}
        futures.update({w: pool.submit(dp_check.run_ranks, w, specs, os.path.join(root, str(w)))
                        for w, specs in by_world.items()})
        whole = dp_check.band_pieces(DataMesh(), "cpu", pieces)
        jax_out = _jax_head(variables, pieces["levels"])
        out = {w: futures[w].result() for w in by_world}
        ones = futures["ref"].result()
    finally:
        pool.shutdown(wait=True)
    res = {"whole": whole, "jax": jax_out}
    for name, n in PIECE_CASES.items():
        res[name] = [r[0] for r in out[n]]
    for name, spec in steps.items():
        w = spec["n_model"]
        i = [k for k, s in steps.items() if s["n_model"] == w].index(name)
        i += sum(1 for n in PIECE_CASES.values() if n == w)
        res[name] = (ones[name], [r[i] for r in out[w]])
    return res


def _jax_head(variables, levels) -> dict:
    """JAX's kernel head and its Semantic-FPN on the whole map, each
    jitted once."""
    feats = [x.numpy() for x in levels]
    head = JConvKernelHead(jconfig.ConvKernelHeadConfig(**_head_kw()))
    fpn = JSemanticFPN(feat_channels=C, out_channels=C)
    rpn = jax.jit(head.apply)(variables, feats)
    loc = jax.jit(fpn.apply)({"params": variables["params"]["localization_fpn"]}, feats)
    return {**{f"fpn.{i}": np.asarray(x) for i, x in enumerate(loc)},
            **{f"head.{k}": np.asarray(getattr(rpn, k)) for k in
               ("proposal_feats", "x_feats", "mask_preds", "seg_preds", "thing_mask_preds")}}


def _assemble(ranks: list, key: str) -> torch.Tensor:
    how, _ = ranks[0][key]
    parts = [r[key][1] for r in ranks]
    if how.startswith("rows:"):
        return torch.cat(parts, int(how.split(":")[1]))
    if how == "sum":
        return sum(parts)
    for p in parts[1:]:  # "same": every rank holds the whole value
        assert torch.equal(p, parts[0]), key
    return parts[0]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


# ------------------------------------------------------------------ the pieces


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_banded_pieces_match_the_whole_map(runs, case):
    """Each piece's bands, assembled, against the whole map's: the resizes
    and the positional encoding bit for bit, the rest within PIECE_REL, a
    gradient through a halo within HALO_REL."""
    whole, ranks = runs["whole"], runs[case]
    keys = [k for k in whole if k != "comm" and not k.startswith(("fpn.", "head."))]
    assert len(keys) == 24
    for k in keys:
        got, want = _assemble(ranks, k), whole[k][1]
        if k in EXACT:
            assert torch.equal(got, want), (case, k)
        else:
            tol = HALO_REL if k.endswith(".grad") or k.endswith("_grad") else PIECE_REL
            assert _rel(got, want) <= tol, (case, k, _rel(got, want))


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_banded_pieces_exchange_rows_and_sums_but_gather_nothing(runs, case):
    """The bands' units are the image's stride-32 rows (3 + 3, or 2 + 2 +
    1 + 1); the ranks lent halo rows and summed partial sums over the
    group, and gathered nothing."""
    ranks = runs[case]
    units = model_axis.band_units(H, PIECE_CASES[case])
    assert [r["positional_encoding"][1].shape[0] for r in ranks] == units
    assert [r["group_norm"][1].shape[1] for r in ranks] == [4 * u for u in units]
    for r in ranks:
        assert r["comm"]["gather"] == 0 and r["comm"]["halo"] > 0 and r["comm"]["reduce"] > 0


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_banded_head_matches_jax_on_the_whole_map(runs, case):
    """The port's Semantic-FPN and kernel head on the bands, assembled,
    against JAX's on the whole map (the init masks by K2 on the band, the
    pooled features by K1 summed over the bands)."""
    ranks, want = runs[case], runs["jax"]
    for k, w in want.items():
        got = _assemble(ranks, k)
        if k == "head.proposal_feats":
            w = w.reshape(got.shape)
        assert _rel(got, w) <= HEAD_REL, (case, k, _rel(got, w))
    # the whole map in this process agrees with the bands
    for k in want:
        assert _rel(_assemble(ranks, k), runs["whole"][k][1]) <= HALO_REL, (case, k)


# ------------------------------------------------------------------ whole steps


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_banded_step_equals_one_process(runs, case):
    """Every rank's losses and first gradient (DDP's sum over the world of
    the ranks' shares) against the one-process step: the loss share and
    `model_sum`'s backward give each parameter its gradient once."""
    one, ranks = runs[case]
    n_model, hw = STEP_CASES[case]
    units = model_axis.band_units(hw[0], n_model)
    assert [r["inputs"] for r in ranks] == [[(2, 32 * u, hw[1], 3)] for u in units]
    for r in ranks:
        assert r["replayed"] == [True]
        for k, w in one["losses"][0].items():
            got = r["losses"][0][k]
            assert abs(got - w) <= LOSS_REL * max(abs(w), 1e-6), (case, k, got, w)
        assert set(r["grads"]) == set(one["grads"])
        for k, g in one["grads"].items():
            scale = float(g.abs().max())
            if k.endswith(".key.bias"):  # zero up to rounding
                scale = float(one["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((r["grads"][k] - g).abs().max()) <= GRAD_REL * max(scale, 1e-12), \
                (case, k)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_banded_step_gathers_only_for_the_whole_map_consumers(runs, case):
    """R-50 and Swin-tiny gather nothing; MiT-b0 gathers its keys, the RoI
    head the whole fused map and the aligned head the whole pyramid. Every
    step sums over the group."""
    _, ranks = runs[case]
    for r in ranks:
        comm = r["comm"][0]
        assert comm["halo"] > 0 and comm["reduce"] > 0, comm
        assert (comm["gather"] > 0) == case.startswith(WHOLE_MAP_CONSUMERS), comm
