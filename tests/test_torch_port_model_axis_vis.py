"""The VIS heads and the tube losses on the frame split of the mesh's
`model` axis (`parallel/model_axis.py`): no rank gathers the pyramid; the
per-frame heads and losses run on the rank's frames of each clip, the
clip kernels' merge gathers only the per-frame kernels, and every sum over
the clip's frames is the rank's partial sum, summed over the `model`
group.

The pieces (`tools/dp_check.py:frame_pieces`, gloo ranks in processes of
their own) against the same code on the whole clips in this process, for
2 clips of 5 frames over 2 ranks (3 + 2: uneven) and of 4 frames over 4
ranks (one each): the temporal positional encoding bit for bit; the
attention merge, the clip stages' mean over T, the tube costs, the tube
losses (cls, BCE and dice over T*H*W), the volume head's init losses and
the per-frame init-head and stage losses (their shares summed) within
PIECE_REL of each result's largest magnitude, every input's gradient
within GRAD_REL. The same ranks' kernel head (the temporal encoding), stage
loop and clip head (`query_merge_method="attention"`, a per-frame stage),
assembled, against JAX's modules jitted on the whole clips within HEAD_REL
of each output's scale (`tests/test_torch_port_model_axis_heads.py`'s
tolerance).

Whole steps over 2 ranks against one process (`dp_check.run_reference`,
whose ReLU decisions the ranks replay on their frames, in the heads too),
clips of 5 frames (3 + 2) at 64x96, the tiny VIS config
(`train_check.vis_check_cfg`, MiT-b0): frame mode with the attention
merge, volume mode, and Swin-tiny at drop-path rate 0.3 with the
`attention_pos` merge and `with_mask_init`. Losses within 1e-4, each
gradient leaf within 1e-3 of its scale, each rank's backbone took its
frames; the ranks gather the per-frame kernels only (under 1% of the
pyramid's bytes; none in volume mode) and sum over the group. And
`pyramid_share` under the frame split: each rank's frames of each level,
gathered nowhere.
"""

import concurrent.futures
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch_port_common import perturbed_variables, port_of

import video_knet_tpu.config_vis as jconfig_vis
from video_knet_tpu.models.kernel_head import ConvKernelHead as JConvKernelHead
from video_knet_tpu.models.kernel_iter_head import KernelIterHead as JKernelIterHead
from video_knet_tpu.models.vis.clip_head import ClipKernelHead as JClipKernelHead
from video_knet_tpu_torch import config_vis as tconfig_vis
from video_knet_tpu_torch.models.backbones import build_backbone, build_neck, pyramid_width
from video_knet_tpu_torch.models.kernel_head import ConvKernelHead
from video_knet_tpu_torch.models.kernel_iter_head import KernelIterHead
from video_knet_tpu_torch.models.layers import init_parameters
from video_knet_tpu_torch.models.vis.clip_head import ClipKernelHead
from video_knet_tpu_torch.models.vis.knet_vis import frame_gt_from_clip
from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.parallel.mesh import DataMesh
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools.train_check import relu_pattern, vis_check_cfg
from video_knet_tpu_torch.train import vis as tvis

torch.set_num_threads(1)

B, N, C, K, G = 2, 8, 64, 5, 4  # clips, proposals, head width, classes, tube slots
H, W = 8, 12  # the heads' map (stride 8 of 64x96); the GT's at stride 4
HW = (64, 96)
PIECE_CASES = {"5_frames_over_2": (5, 2), "4_frames_over_4": (4, 4)}
PIECE_REL, GRAD_REL, HEAD_REL = 1e-6, 1e-5, 1e-4
LOSS_REL, STEP_GRAD_REL = 1e-4, 1e-3
STEP_CASES = ("frame_attention", "volume", "swin_tiny_drop_path")
STEP_FRAMES = 5


def _cfgs(**change):
    """The check config of both packages (the attention merge, `change`
    applied): (JAX's, the port's)."""
    change = {"query_merge_method": "attention", **change}
    pair = [dataclasses.replace(vis_check_cfg(mod.VISConfig()), **change)
            for mod in (jconfig_vis, tconfig_vis)]
    assert dataclasses.asdict(pair[0]) == dataclasses.asdict(pair[1])
    return pair


def _assignment(valid: np.ndarray, rng) -> torch.Tensor:
    """[L, N] gt-of-pred: each valid GT slot of each lane on a distinct
    proposal, -1 elsewhere (as the solve leaves them)."""
    out = np.full((valid.shape[0], N), -1, np.int32)
    for lane, ok in enumerate(valid):
        preds = rng.permutation(N)[:G]
        out[lane, preds[ok]] = np.arange(G, dtype=np.int32)[ok]
    return torch.from_numpy(out)


def _inputs(t: int, seed: int) -> dict:
    """The whole clips' tensors the pieces cut their frames from."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    cfg = _cfgs()[1]
    gt = tvis.make_synthetic_clip_gt(cfg, B, t, (2 * H, 2 * W), seed=seed, device="cpu")
    frame_valid = frame_gt_from_clip(gt).valid.numpy()
    return dict(
        pe_thwc=(t, H // 4, W // 4, C), kernels=f(B, t, N, C), merge_cot=f(B, N, C),
        pooled=f(B, t, N, C), gt=tuple(gt), scaled=f(B, t, N, 2 * H, 2 * W, scale=3.0),
        cls=f(B, N, K), tube_assign=_assignment(gt.valid.numpy(), rng),
        tubes=f(B, t, N, H, W, scale=3.0), seg=f(B, t, H, W, K),
        frame_masks=f(B, t, N, H, W, scale=3.0), frame_cls=f(B, t, N, K),
        frame_seg=f(B, t, H, W, K),
        frame_assign=_assignment(frame_valid, rng).reshape(B, t, N),
        levels=[f(B, t, 2 * H // s, 2 * W // s, C) for s in (1, 2, 4, 8)])


def _heads(seed: int = 3) -> tuple[dict, dict]:
    """(the pieces' heads: configs and state dicts, JAX's variables of
    them), weights drawn by the port, norms perturbed."""
    cfg = _cfgs()[1]
    mods = {"rpn": ConvKernelHead(cfg.rpn, in_channels=C),
            "roi": KernelIterHead(cfg.head, num_stages=cfg.num_stages),
            "clip": ClipKernelHead(cfg.head, num_stages=cfg.tracker_num_stages,
                                   assign_stages=cfg.tracker_assign_stages,
                                   num_proposals=cfg.num_proposals,
                                   query_merge_method=cfg.query_merge_method)}
    variables = {}
    for i, (k, m) in enumerate(mods.items()):
        init_parameters(m, torch.Generator().manual_seed(seed + i))
        variables[k] = perturbed_variables(m, seed=seed + i)
        port_of(m, variables[k])
    heads = {k: m.state_dict() for k, m in mods.items()}
    heads.update(cfg=cfg, volume_cfg=dataclasses.replace(cfg, kernel_head_mode="volume"))
    return heads, variables


def _jax_heads(variables, levels: list, t: int) -> dict:
    """JAX's kernel head (the temporal encoding), stage loop and clip head
    on the whole clips, as JAX's KNetVIS runs them, jitted once."""
    jcfg = _cfgs()[0]

    def fwd(v, feats):
        rpn = JConvKernelHead(jcfg.rpn).apply(v["rpn"], feats, num_frames=t)
        stages = JKernelIterHead(jcfg.head, num_stages=jcfg.num_stages).apply(
            v["roi"], rpn.x_feats, rpn.proposal_feats, rpn.mask_preds)
        last = stages[-1]
        x_clip = rpn.x_feats.reshape(B, t, *rpn.x_feats.shape[1:])
        clip = JClipKernelHead(jcfg.head, num_stages=jcfg.tracker_num_stages,
                               assign_stages=jcfg.tracker_assign_stages,
                               num_proposals=jcfg.num_proposals,
                               query_merge_method=jcfg.query_merge_method).apply(
            v["clip"], x_clip, last.object_feats[:, :N, 0, :].reshape(B, t, N, C),
            last.mask_preds[:, :N].reshape(B, t, N, *last.mask_preds.shape[-2:]))
        return rpn, stages, clip

    feats = [x.reshape(B * t, *x.shape[2:]).numpy() for x in levels]
    rpn, stages, clip = jax.jit(fwd)(variables, feats)
    out = {f"rpn.{k}": np.asarray(getattr(rpn, k))
           for k in ("x_feats", "mask_preds", "seg_preds", "proposal_feats")}
    for s, st in enumerate(stages):
        out.update({f"roi.s{s}.{k}": np.asarray(getattr(st, k))
                    for k in ("cls_score", "mask_preds", "object_feats")})
    for s, st in enumerate(clip):
        if st.cls_score is not None:
            out[f"clip.s{s}.cls_score"] = np.asarray(st.cls_score)
        out[f"clip.s{s}.mask_preds"] = np.asarray(st.mask_preds)
        out[f"clip.s{s}.object_feats"] = np.asarray(st.object_feats)
    return out


def _step_spec(name: str) -> dict:
    if name == "volume":
        cfg = _cfgs(kernel_head_mode="volume")[1]
    elif name.startswith("swin"):
        cfg = _cfgs(backbone="swin_tiny", backbone_drop_path_rate=0.3,
                    query_merge_method="attention_pos", with_mask_init=True)[1]
    else:
        cfg = _cfgs()[1]
    cfg = dataclasses.replace(cfg, num_frames=STEP_FRAMES)
    return dict(kind="vis", cfg=cfg, seed=0, n_model=2,
                batches=[tvis.make_synthetic_batch(cfg, 1, HW, seed=0, device="cpu")])


def _pyramid_spec() -> tuple[dict, dict]:
    """MiT-b0 + FPN under the frame split (2 clips of 5 frames over 2
    ranks), and the whole forward here."""
    gen = torch.Generator().manual_seed(4)
    backbone = build_backbone("mit_b0")
    neck = build_neck("fpn", backbone)
    init_parameters(backbone, gen)
    init_parameters(neck, gen)
    backbone.eval(), neck.eval()
    rng = np.random.RandomState(4)
    img = torch.from_numpy(rng.randn(B * STEP_FRAMES, *HW, 3).astype(np.float32))
    cot = [torch.from_numpy(rng.randn(B * STEP_FRAMES, HW[0] // s, HW[1] // s,
                                      neck.out_channels).astype(np.float32))
           for s in (4, 8, 16, 32)]
    relus: list = []
    with relu_pattern(relus), torch.no_grad():
        levels = neck(backbone(img))
    spec = dict(kind="pyramid", n_model=2, backbone="mit_b0", img=img, cotangents=cot,
                weights=(backbone.state_dict(), neck.state_dict()), relus=relus,
                frames=STEP_FRAMES)
    return spec, {"levels": levels}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks (2 ranks: the 5-frame pieces, the steps and the
    pyramid; 4: the 4-frame pieces) and the steps' one-process runs, each
    in processes of their own, started at once: the ranks build their
    models while the reference runs, then wait for its ReLU decisions.
    Meanwhile, here: the pieces on the whole clips and JAX's heads."""
    root = str(tmp_path_factory.mktemp("model_axis_vis"))
    heads, variables = _heads()
    inputs = {name: _inputs(t, seed=i) for i, (name, (t, _)) in enumerate(PIECE_CASES.items())}
    pieces = {name: dict(kind="frame_pieces", n_model=n, inputs=inputs[name], heads=heads)
              for name, (_, n) in PIECE_CASES.items()}
    steps = {name: _step_spec(name) for name in STEP_CASES}
    relus = {name: os.path.join(root, f"{name}.relus") for name in steps}
    pyramid, whole_pyramid = _pyramid_spec()
    two = ([pieces["5_frames_over_2"]] + [{**s, "relus": relus[k]} for k, s in steps.items()]
           + [pyramid])
    pool = concurrent.futures.ThreadPoolExecutor(3)
    try:
        def reference():
            ones = dp_check.run_reference(list(steps.values()), os.path.join(root, "ref"))
            for name, (one, rec) in zip(steps, ones):
                dp_check.write_relus(relus[name], rec)
            return dict(zip(steps, (one for one, _ in ones)))

        futures = {"ref": pool.submit(reference),
                   2: pool.submit(dp_check.run_ranks, 2, two, os.path.join(root, "2")),
                   4: pool.submit(dp_check.run_ranks, 4, [pieces["4_frames_over_4"]],
                                  os.path.join(root, "4"))}
        whole = {name: dp_check.frame_pieces(DataMesh(), "cpu", spec)
                 for name, spec in pieces.items()}
        jax_out = {name: _jax_heads(variables, inputs[name]["levels"], t)
                   for name, (t, _) in PIECE_CASES.items()}
        ranks = {w: futures[w].result() for w in (2, 4)}
        ones = futures["ref"].result()
    finally:
        pool.shutdown(wait=True)
    res = {"whole": whole, "jax": jax_out, "pyramid": (whole_pyramid,
                                                       [r[-1] for r in ranks[2]])}
    res["5_frames_over_2"] = [r[0] for r in ranks[2]]
    res["4_frames_over_4"] = [r[0] for r in ranks[4]]
    for i, name in enumerate(steps):
        res[name] = (ones[name], [r[1 + i] for r in ranks[2]])
    return res


def _assemble(ranks: list, key: str) -> torch.Tensor:
    """The ranks' results of one piece as the whole clips' (see
    `dp_check._frame_piece_results`)."""
    how, _ = ranks[0][key]
    parts = [r[key][1] for r in ranks]
    if how.startswith("frames:"):
        return torch.cat(parts, int(how.split(":")[1]))
    if how == "rows":  # [B*T_r, ...] each
        return torch.cat([p.reshape(B, -1, *p.shape[1:]) for p in parts], 1).reshape(
            -1, *parts[0].shape[1:])
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
def test_frame_pieces_match_the_whole_clips(runs, case):
    """Each piece's frames, assembled, against the whole clips': the
    temporal encoding bit for bit, the merge, the clip mean, the costs and
    the losses within PIECE_REL, their gradients within GRAD_REL."""
    whole, ranks = runs["whole"][case], runs[case]
    keys = [k for k in whole if k != "comm" and not k.startswith(("rpn.", "roi.", "clip."))]
    assert len(keys) == 27
    for k in keys:
        got, want = _assemble(ranks, k), whole[k][1]
        if k == "positional_encoding":
            assert torch.equal(got, want), (case, k)
        else:
            tol = GRAD_REL if ".grad." in k else PIECE_REL
            assert _rel(got, want) <= tol, (case, k, _rel(got, want))


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_frame_pieces_gather_only_the_kernels(runs, case):
    """Each rank took its frames (3 + 2, or 1 each); it gathered the
    per-frame kernels of the merge alone (its frames forward, the whole
    clips' gradient back), exchanged no halo, and summed over the group."""
    t, n_model = PIECE_CASES[case]
    ranks = runs[case]
    counts = model_axis.frame_counts(t, n_model)
    assert [r["positional_encoding"][1].shape[0] for r in ranks] == counts
    assert [r["merge.grad.kernels"][1].shape[1] for r in ranks] == counts
    share, whole = (4 * B * N * C * f for f in (max(counts), t))  # padded to the longest share
    for r in ranks:
        comm = r["comm"]
        # the merge piece's forward and backward, the clip head's forward
        assert comm["gather"] == 2 * share + whole, comm
        assert comm["halo"] == comm["ring"] == 0 and comm["reduce"] > 0, comm


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_frame_split_heads_match_jax_on_the_whole_clips(runs, case):
    """The port's kernel head, stage loop and clip head on the frames,
    assembled, against JAX's on the whole clips; and against the port's
    whole-clip run in this process."""
    ranks, want = runs[case], runs["jax"][case]
    assert len(want) == 4 + 3 * 3 + 3 * 2 + 2
    for k, w in want.items():
        got = _assemble(ranks, k)
        if k == "rpn.proposal_feats":
            w = w.reshape(got.shape)
        assert _rel(got, w) <= HEAD_REL, (case, k, _rel(got, w))
        assert _rel(got, runs["whole"][case][k][1]) <= HEAD_REL, (case, k)


# ------------------------------------------------------------------ whole steps


def _pyramid_bytes(cfg) -> int:
    """The bytes of one clip's pyramid (fp32): what each rank handed to the
    gather before the heads ran on frames, at least."""
    backbone = build_backbone(cfg.backbone)
    width = pyramid_width(backbone, build_neck(cfg.neck_type, backbone))
    return 4 * STEP_FRAMES * width * sum((HW[0] // s) * (HW[1] // s) for s in (4, 8, 16, 32))


@pytest.mark.parametrize("case", STEP_CASES)
def test_frame_split_step_equals_one_process(runs, case):
    """Every rank's losses and first gradient (DDP's sum over the world of
    the ranks' shares) against the one-process step: the loss share,
    `frame_sum`'s and the kernels' gather's backward give each parameter
    its gradient once; each rank's backbone took its frames."""
    one, ranks = runs[case]
    assert [r["inputs"] for r in ranks] == [[(c, *HW, 3)] for c in
                                            model_axis.frame_counts(STEP_FRAMES, 2)]
    for r in ranks:
        assert r["replayed"] == [True]
        assert set(r["losses"][0]) == set(one["losses"][0])
        for k, w in one["losses"][0].items():
            got = r["losses"][0][k]
            assert abs(got - w) <= LOSS_REL * max(abs(w), 1e-6), (case, k, got, w)
        assert set(r["grads"]) == set(one["grads"])
        for k, g in one["grads"].items():
            scale = float(g.abs().max())
            if k.endswith(".key.bias"):  # zero up to rounding
                scale = float(one["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((r["grads"][k] - g).abs().max()) <= STEP_GRAD_REL * max(scale, 1e-12), \
                (case, k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_frame_split_step_gathers_no_pyramid(runs, case):
    """No rank gathers the pyramid: the gather holds the per-frame kernels
    of the merge (none in volume mode), under 1% of the clip's pyramid;
    the sums over the clip's frames are reduced over the group."""
    one, ranks = runs[case]
    cfg = _step_spec(case)["cfg"]
    pyramid = _pyramid_bytes(cfg)
    for r in ranks:
        comm = r["comm"][0]
        assert comm["reduce"] > 0 and comm["halo"] == 0, comm
        assert comm["gather"] < 0.01 * pyramid, (comm, pyramid)
        assert (comm["gather"] == 0) == (case == "volume"), comm


def test_pyramid_share_under_the_frame_split(runs):
    """MiT-b0 + FPN: each rank's frames of each level (rows b*T + t of its
    frames), gathered nowhere, within 1e-5 of the whole forward's."""
    whole, ranks = runs["pyramid"]
    for m, r in enumerate(ranks):
        rows = model_axis.frame_rows(B, STEP_FRAMES, model_axis.Split("frames", None, m, 2))
        assert r["inputs"] == [(len(rows), *HW, 3)]
        assert r["comm"]["gather"] == 0 and r["comm"]["halo"] == 0
        for i, want in enumerate(whole["levels"]):
            assert r["rows"][i] == rows.tolist()
            assert _rel(r["levels"][i], want[rows]) <= 1e-5, (m, i)
