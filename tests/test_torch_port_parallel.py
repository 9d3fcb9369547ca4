"""Live BatchNorm (`norm_eval=False`) and data parallelism of the port on
the CPU, against the JAX package and against the port in one process.

Against JAX (its jobs in processes of their own,
`tests/torch_port_jax_jobs.py`):
- ResNet-50 at 64x96, B=2, in training mode with `norm_eval=False`
  against JAX's `ResNet(train=True, norm_eval=False)` applied with mutable
  `batch_stats`: the outputs (within OUT_REL of each output's largest
  magnitude), the input gradient (zero on both sides: `frozen_stages=1`
  stops it after layer1), the parameter gradients (each leaf within 1e-3
  of its largest magnitude, the port replaying JAX's ReLU decisions as
  `tests/test_torch_port_train.py` does), the new statistics leaf for leaf
  (within STATS_REL) and the frozen stem's and layer1's statistics
  unchanged, bit for bit.
- A one-stage R-50 `VideoKNetConfig(max_insts=4, norm_eval=False)` at
  64x96, global batch 2, two steps on one batch, against one compile of
  JAX's `make_sharded_train_step` on a two-device `data` mesh (its model
  seen through a proxy that hands its ReLU decisions to the host, its
  optimizer through one that hands over the first gradient), by the port
  in one process at B=2 and over two gloo ranks at B=1 each, both
  replaying JAX's ReLU decisions: each step's losses within LOSS_REL
  relative, the first step's gradient (on the ranks: summed over them)
  within GRAD_REL of each leaf's largest magnitude, the BatchNorm
  statistics after the steps within STATS_REL. The updated parameters
  are held through the gradient: under the CLI optimizer's warmup (lr(0)
  = 1e-7) an AdamW step moves an element by about lr whatever its
  gradient, so the parameters after two steps cannot tell a right
  gradient from a wrong one; `test_torch_port_train.py` holds the
  optimizer's update on equal gradients.
- The VIS loss of an R-50 KNetVIS with `norm_eval=False` (T=2, B=2 clips
  folded into 4 frames for the statistics) against JAX's
  `make_vis_loss_fn`: losses within LOSS_REL, new statistics within
  STATS_REL.

Two gloo ranks at B=1 against one process at B=2 (`tools/dp_check.py`:
each case's one-process run in a process of its own, then its ranks,
joined through a `file://` store under the test's temporary directory, so
that concurrent runs never share a port; each rank replays the
one-process run's ReLU decisions on its rows, `train_check.relu_pattern`,
so that a ReLU input within rounding of zero cannot send the two
backwards down different sides of its kink). Cases, two steps each: the
R-50 live-BN VPS step above; an R-50 KNetVIS with live BatchNorm on two
batches; the image K-Net with rank 1's image free of positives (no
thing, no stuff: a clamp of its local counts would differ from the
global one); the tiny VPS model with rank 1's pair free of positives (the
tracker's batch means too); the roi_gt_box track head (its last stage's
link takes no gradient: DDP looks for unused parameters); Swin-tiny VPS
with stochastic depth (rate 0.3: each rank keeps its rows of the global
batch's draws). The live-BN VPS case replays JAX's decisions instead,
on both sides. Tolerances: each step's losses within 1e-4 relative; the
first step's gradient, summed over the ranks, within 1e-3 of each leaf's
largest magnitude (an attention's key bias, whose true gradient is zero,
against its kernel's); BatchNorm statistics within 1e-5 of each leaf's
largest magnitude; every parameter within 1e-6 (which the warmup bounds
anyway, as above). The two ranks' states are bit-equal.

Also: the mesh and process-group helpers against the JAX package's, the
loaders' rank rows, and `train_vps` over two ranks (2 steps, then 2 more
resumed) against one process. Everything heavy starts at once in the
module fixture, while this process runs the port's one-process side.
"""

import concurrent.futures
import dataclasses
import importlib
import io
import json
import os
import shutil
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch_port_common import (
    _collect,
    _spawn,
    _tiny_image_cfg,
    jax_relu_decisions,
    no_positives,
    perturbed_variables,
    rel_err,
    weight_of,
)

import video_knet_tpu.config as jconfig
import video_knet_tpu.config_vis as jconfig_vis
import video_knet_tpu.parallel.distributed as jdist
import video_knet_tpu.parallel.mesh as jmesh
import video_knet_tpu_torch.config as tconfig
import video_knet_tpu_torch.config_vis as tconfig_vis
from video_knet_tpu_torch.data import datasets as tds
from video_knet_tpu_torch.data.loader import VPSTrainLoader
from video_knet_tpu_torch.data.vis_loader import VISTrainLoader
from video_knet_tpu_torch.data.ytvis import YouTubeVISDataset
from video_knet_tpu_torch.models.resnet import ResNet
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
from video_knet_tpu_torch.ops.targets import PanopticGT
from video_knet_tpu_torch.parallel import distributed as tdist
from video_knet_tpu_torch.parallel import mesh as tmesh
from video_knet_tpu_torch.parallel.mesh import DataMesh
from video_knet_tpu_torch.tools import dp_check
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.data_check import write_kitti_step_tree, write_ytvis_cocovid
from video_knet_tpu_torch.tools.train_check import relu_pattern, swin_check_cfg, track_check_cfg
from video_knet_tpu_torch.train import image as timage
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train import vis as tvis
from video_knet_tpu_torch.train import vps as tvps
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.utils.checkpoint import load_model_state
from video_knet_tpu_torch.utils.convert import (
    flatten_variables,
    load_flax_variables,
    state_dict_to_flax,
)

HW = (64, 96)
# Live statistics come from few values at 64x96 (layer4: 2x3 pixels of each
# of 2 images, 12 a channel), and each live BatchNorm divides the forward's
# rounding (reductions summed in another order than XLA's) by the batch's
# own standard deviation, so the two packages drift apart stage by stage:
# measured 4.9e-7, 1.1e-5, 4.8e-5 and 4.8e-4 of the stage outputs' largest
# magnitudes, 3.8e-5 in the new statistics, 1.1e-4 in the VPS losses.
OUT_REL = 1e-3
STATS_REL = 1e-4
LOSS_REL = 5e-4
# the first step's gradient, each leaf against its largest magnitude; the
# port replays JAX's ReLU decisions (without that, 82 of 7.65M ReLU inputs
# within rounding of zero go the other way and move layer4's gradients by
# up to 45%); measured 7.4e-4 at worst (layer4_block0/conv2)
GRAD_REL = 1e-3
FROZEN = ("bn1/", "layer1_")
ONE_STAGE = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
CLI_TREE_FRAMES = 8  # one sequence: two steps an epoch at a global batch of 4


def _batch_np(batch) -> tuple:
    return (batch.img.numpy(), batch.ref_img.numpy(), [x.numpy() for x in batch.gt],
            [x.numpy() for x in batch.ref_gt])


def _vis_cfgs():
    """The R-50 live-BN VIS config of either package, (JAX's, the port's)."""
    out = []
    for mod in (jconfig_vis, tconfig_vis):
        cfg = mod.VISConfig()
        split = dict(num_classes=5, num_thing_classes=5, num_stuff_classes=0)
        out.append(dataclasses.replace(
            cfg, norm_eval=False, num_classes=5, num_proposals=8, num_frames=2, max_insts=4,
            tracker_num_stages=1, tracker_assign_stages=1, tracker_stage_loss_weights=(1.0,),
            rpn=dataclasses.replace(cfg.rpn, num_proposals=8, **split),
            head=dataclasses.replace(cfg.head, **split), **ONE_STAGE))
    return out


def _cases(vps_weights: dict) -> dict:
    """The data-parallel cases; the R-50 live-BN VPS case starts from
    `vps_weights` (the JAX check's), its two steps on seed 0's batch (seed
    1's holds a Hungarian near-tie at stage 0 that the two packages'
    rounding decides apart, 0.33% of s0_loss_mask)."""
    r50 = tconfig.VideoKNetConfig(max_insts=4, norm_eval=False, **ONE_STAGE)
    tiny = dataclasses.replace(tg.tiny_cfg(), **ONE_STAGE)
    vis = _vis_cfgs()[1]
    image = dataclasses.replace(_tiny_image_cfg(tconfig.KNetConfig()), **ONE_STAGE)
    swin = dataclasses.replace(swin_check_cfg(tiny), backbone_drop_path_rate=0.3)
    roi = track_check_cfg(tiny, "roi_gt_box")

    def vps(cfg, seeds, empty=False):
        out = []
        for s in seeds:
            b = tvps.make_synthetic_batch(cfg, 2, HW, seed=s, device="cpu")
            if empty:
                b = b._replace(gt=no_positives(b.gt, 1), ref_gt=no_positives(b.ref_gt, 1))
            out.append(b)
        return out

    images = []
    for s in (0, 1):
        b = timage.make_synthetic_batch(image, 2, HW, seed=s, device="cpu")
        images.append(b._replace(gt=no_positives(b.gt, 1)))
    return {
        "vps_live_bn": dict(kind="vps", cfg=r50, seed=0, weights=vps_weights,
                            batches=[tvps.make_synthetic_batch(r50, 2, HW, seed=0,
                                                               device="cpu")] * 2),
        "vis_live_bn": dict(kind="vis", cfg=vis, seed=0, batches=[
            tvis.make_synthetic_batch(vis, 2, HW, seed=s, device="cpu") for s in (0, 1)]),
        "image_no_positives": dict(kind="image", cfg=image, seed=0, batches=images),
        "vps_no_positives": dict(kind="vps", cfg=tiny, seed=0, batches=vps(tiny, (0, 1), True)),
        "vps_roi_gt_box": dict(kind="vps", cfg=roi, seed=0, batches=vps(roi, (2, 3))),
        "vps_swin_drop_path": dict(kind="vps", cfg=swin, seed=0, batches=vps(swin, (4, 5))),
    }


def _cli_argv(tree: str, work: str, epochs: int, *extra) -> list:
    return ["video_knet_tpu_torch.tools.train_vps", "--data-root", tree, "--backbone", "mit_b0",
            "--epochs", str(epochs), "--batch-size", "4", "--crop", *map(str, HW),
            "--max-insts", "4", "--log-interval", "1", "--work-dir", work, "--device", "cpu",
            *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX jobs, every case's one-process run and its two ranks (in
    four pipelines of processes), `train_vps` over two ranks (2 steps, then
    2 more resumed); meanwhile, in this process, the port's side of the
    ResNet and VIS checks and the one-process `train_vps` (4 steps)."""
    root = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.RandomState(0)
    jobs = {}
    pool = concurrent.futures.ThreadPoolExecutor(6)
    try:
        # the VPS step first: its JAX compile is the longest job
        jcfg, tcfg = (mod.VideoKNetConfig(max_insts=4, norm_eval=False, **ONE_STAGE)
                      for mod in (jconfig, tconfig))
        vps_vars = perturbed_variables(VideoKNet(tcfg, generator=torch.Generator().manual_seed(0),
                                        device="cpu"), seed=1)
        vps_model = load_flax_variables(VideoKNet(tcfg, device="cpu"), vps_vars)
        vps_weights = {k: v.clone() for k, v in vps_model.state_dict().items()}
        cases = _cases(vps_weights)
        vps_job = _spawn(root, "sharded_vps", dict(
            job="sharded_vps", cfg=jcfg, variables=vps_vars,
            batches=[_batch_np(b) for b in cases["vps_live_bn"]["batches"]]), nice=0, devices=2)
        jobs["vps"] = vps_job
        resnet = ResNet(depth=50, frozen_stages=1, norm_eval=False)
        bn_vars = perturbed_variables(_init_resnet(resnet), seed=3)
        x = rng.randn(2, *HW, 3).astype(np.float32)
        cot = [rng.randn(2, HW[0] // s, HW[1] // s, c).astype(np.float32)
               for s, c in zip((4, 8, 16, 32), resnet.out_channels)]
        jobs["bn"] = _spawn(root, "live_bn_resnet", dict(
            job="live_bn_resnet", variables=bn_vars, x=x, cotangents=cot), nice=5)
        vis_j, vis_t = _vis_cfgs()
        vis_vars = perturbed_variables(KNetVIS(vis_t, generator=torch.Generator().manual_seed(4),
                                      device="cpu"), seed=5)
        vis_batch = tvis.make_synthetic_batch(vis_t, 2, HW, seed=0, device="cpu")
        jobs["vis"] = _spawn(root, "vis_live_bn", dict(
            job="vis_live_bn", cfg=vis_j, variables=vis_vars, clip=vis_batch.clip.numpy(),
            gt=[g.numpy() for g in vis_batch.gt]), nice=5)

        tree = os.path.join(root, "kitti")
        write_kitti_step_tree(tree, n_seqs=1, n_frames=CLI_TREE_FRAMES, hw=HW, n_things=4)

        def cli_ranks():
            work = os.path.join(root, "cli_ranks")
            outs = []
            for epochs, extra in ((1, ()), (2, ("--resume-from",
                                                os.path.join(work, "ckpt", "step_1")))):
                url = "file://" + os.path.join(root, f"cli_store_{epochs}")
                outs.append(dp_check.launch(2, _cli_argv(tree, work, epochs, "--dist-url", url,
                                                         *extra), root))
            return work, outs

        def pipeline(tag: str, names: list, extra: list = ()):
            """The cases' one-process runs, in a process of their own, then
            all of them over two ranks."""
            refs = dp_check.run_reference([cases[n] for n in names], os.path.join(root, tag))
            specs = [{**cases[n], "relus": relus} for n, (_, relus) in zip(names, refs)]
            return ({n: res for n, (res, _) in zip(names, refs)},
                    dp_check.run_ranks(2, specs + list(extra), os.path.join(root, tag)))

        def vps_pipeline():
            """JAX's sharded step, then the port's one-process run and its
            two ranks at once, both replaying JAX's ReLU decisions."""
            want = _collect(*vps_job)
            case = cases["vps_live_bn"]
            relus = []  # in the order of the port's ReLU calls
            for step, b in zip(want["relus"], case["batches"]):
                with torch.no_grad():
                    relus.append(jax_relu_decisions(
                        step, vps_model, lambda b=b: vps_model.forward_train(b.img, b.ref_img)))
            spec, tmp = {**case, "relus": relus}, os.path.join(root, "vps")
            with concurrent.futures.ThreadPoolExecutor(1) as one:  # the last job: 8 threads
                ref = one.submit(dp_check.run_reference, [spec], tmp, threads=2)
                per_rank = dp_check.run_ranks(2, [spec], tmp, threads=3)
                return want, ref.result()[0][0], [r[0] for r in per_rank]

        items = [[f"rank{r}-{i}" for i in range(3 - r)] for r in range(2)]
        groups = {"vis": ["vis_live_bn"], "swin": ["vps_swin_drop_path"],
                  "rest": ["image_no_positives", "vps_no_positives", "vps_roi_gt_box"]}
        vps_future = pool.submit(vps_pipeline)
        extra = [dict(kind="gather", items=items), dict(kind="any_rank", flags=[False, True]),
                 dict(kind="any_rank", flags=[False, False]), dict(kind="replicated")]
        futures = {tag: pool.submit(pipeline, tag, names, extra if tag == "rest" else [])
                   for tag, names in groups.items()}
        cli = pool.submit(cli_ranks)

        bn_port = _port_resnet(resnet, bn_vars, x, cot, jobs)
        vis_port = _port_vis(vis_t, vis_vars, vis_batch)
        single = os.path.join(root, "cli_single")
        mod = importlib.import_module("video_knet_tpu_torch.tools.train_vps")
        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "print", lambda *a, **k: print(*a, **k, file=out), raising=False)
            mod.main(_cli_argv(tree, single, 2)[1:])
        one, ranks = {}, {}
        for tag, names in groups.items():
            o, per_rank = futures[tag].result()
            one.update(o)
            ranks.update({name: [r[i] for r in per_rank] for i, name in enumerate(names)})
            if tag == "rest":
                tail = [r[len(names):] for r in per_rank]
        vps_jax, one["vps_live_bn"], ranks["vps_live_bn"] = vps_future.result()
        jobs.pop("vps")
        cli_work, cli_outs = cli.result()
        cli_dirs = {d: sorted(os.listdir(os.path.join(cli_work, d) if d else cli_work))
                    for d in ("", "ckpt")}
        with open(os.path.join(cli_work, "train_log.jsonl")) as f:
            cli_log = [json.loads(line) for line in f]
        final = {k: load_model_state(os.path.join(w, "ckpt", "step_2"))
                 for k, w in (("ranks", cli_work), ("single", single))}
        for w in (cli_work, single):  # the checkpoints hold ~0.4 GB each
            shutil.rmtree(w)
        return dict(root=root, one=one, ranks=ranks, gather=[t[0] for t in tail],
                    stop=[t[1:3] for t in tail], replica=[t[3] for t in tail], items=items,
                    cli_dirs=cli_dirs, cli_log=cli_log, cli_final=final, cli_outs=cli_outs,
                    single_out=out.getvalue(), bn_port=bn_port, vis_port=vis_port,
                    vps_vars=vps_vars, vps_weights=vps_weights, vps_model=vps_model,
                    vps_jax=vps_jax, vis_jax=_collect(*jobs.pop("vis")))
    finally:
        pool.shutdown(wait=True)
        for proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _init_resnet(resnet):
    from video_knet_tpu_torch.models.layers import init_parameters

    init_parameters(resnet, torch.Generator().manual_seed(2))
    return resnet


def _port_resnet(resnet, variables, x, cot, jobs) -> dict:
    """The port's live-BN forward and backward, replaying JAX's ReLU
    decisions (which the JAX job returns, so it is collected here)."""
    load_flax_variables(resnet, variables).eval()
    before = {k: v.clone() for k, v in resnet.state_dict().items()}
    want = _collect(*jobs.pop("bn"))
    with torch.no_grad():  # the call order of the ReLUs (eval mode: no update)
        relus = jax_relu_decisions(want["relus"], resnet, lambda: resnet(torch.from_numpy(x)))
    resnet.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    with relu_pattern(relus, replay=True) as stats:
        outs = resnet(xt)
    assert stats["calls"] == len(relus) > 0
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)).backward()
    resnet.eval()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in resnet.named_parameters()}
    grad_x = np.zeros_like(x) if xt.grad is None else xt.grad.numpy()
    return dict(want=want, outs=[o.detach().numpy() for o in outs], grad_x=grad_x,
                grads=state_dict_to_flax(resnet, grads),
                stats=state_dict_to_flax(resnet, resnet.state_dict()),
                before=state_dict_to_flax(resnet, before))


def _port_vis(cfg, variables, batch) -> dict:
    model = load_flax_variables(KNetVIS(cfg, device="cpu"), variables)
    state = create_train_state(model, toptim.make_optimizer(model, 1000))
    _, losses = tvis.train_step(state, batch)
    return dict(losses={k: float(v) for k, v in losses.items()},
                stats=state_dict_to_flax(model, model.state_dict()))


# ------------------------------------------------------------------ ResNet, live BN


def test_live_bn_outputs_match_jax(runs):
    r = runs["bn_port"]
    for got, want in zip(r["outs"], r["want"]["outs"]):
        assert rel_err(got, want) <= OUT_REL


def test_live_bn_gradients_match_jax(runs):
    r = runs["bn_port"]
    # frozen_stages=1 stops the gradient after layer1 (JAX's stop_gradient)
    assert not np.any(r["grad_x"]) and not np.any(r["want"]["grad_x"])
    want = r["want"]["grads"]
    assert set(r["grads"]) == set(want)
    moved = 0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert float(np.abs(r["grads"][k] - w).max()) <= 1e-3 * max(scale, 1e-12), k
        moved += scale > 0
    frozen = [k for k in want if k.startswith(tuple("params/" + f for f in ("conv1/", *FROZEN)))]
    assert frozen and moved == len(want) - len(frozen)


def test_live_bn_statistics_match_jax(runs):
    """The new running averages leaf for leaf; the frozen stem's and
    layer1's unchanged on both sides, every other leaf moved."""
    r = runs["bn_port"]
    want = r["want"]["batch_stats"]
    got = {k: v for k, v in r["stats"].items() if k.startswith("batch_stats/")}
    assert set(got) == set(want)
    for k, w in want.items():
        assert rel_err(got[k], w) <= STATS_REL, k
        frozen = k.startswith(tuple("batch_stats/" + f for f in FROZEN))
        old = r["before"][k]
        assert (got[k].tobytes() == old.tobytes()) == frozen, k
        assert np.array_equal(w, old) == frozen, k


# ------------------------------------------------------------------ the VPS step


def _assert_losses(got: list, want: list) -> None:
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= LOSS_REL * max(abs(w[k]), 1e-6), (k, g[k], w[k])


@pytest.mark.parametrize("run", ["one_process", "two_ranks"])
def test_vps_step_matches_jax_sharded_step(runs, run):
    """Each step's losses, the first step's gradient (summed over the ranks)
    leaf by leaf, and the BatchNorm statistics after the steps, against
    JAX's sharded step on a two-device mesh."""
    results = ([runs["one"]["vps_live_bn"]] if run == "one_process"
               else runs["ranks"]["vps_live_bn"])
    want, model = runs["vps_jax"], runs["vps_model"]  # the model: its flax leaves' names
    for res in results:
        assert res["replayed"] == [True, True]
        _assert_losses(res["losses"], want["losses"])
        grads = state_dict_to_flax(model, {n: res["grads"].get(n, torch.zeros_like(p))
                                           for n, p in model.named_parameters()})
        moved = 0
        for k, w in want["grads"].items():
            scale = float(np.abs(want["grads"][weight_of(k)]).max())
            assert float(np.abs(grads[k] - w).max()) <= GRAD_REL * max(scale, 1e-12), k
            moved += float(np.abs(w).max()) > 0
        assert moved > len(want["grads"]) // 2
        got = state_dict_to_flax(model, res["state"])
        for k, w in want["batch_stats"].items():
            assert rel_err(got[k], w) <= STATS_REL, k
        start = flatten_variables(runs["vps_vars"])
        moved = [k for k in want["batch_stats"] if not np.array_equal(got[k], start[k])]
        assert moved and not any(k.startswith(tuple("batch_stats/backbone/" + f for f in FROZEN))
                                 for k in moved)


# ------------------------------------------------------------------ VIS


def test_vis_live_bn_loss_and_statistics_match_jax(runs):
    got, want = runs["vis_port"], runs["vis_jax"]
    losses = dict(got["losses"])
    total = losses.pop("total_loss")
    assert set(losses) == set(want["losses"])
    for k, w in want["losses"].items():
        assert abs(losses[k] - w) <= LOSS_REL * max(abs(w), 1e-6), (k, losses[k], w)
    assert abs(total - want["total"]) <= LOSS_REL * abs(want["total"])
    for k, w in want["batch_stats"].items():
        assert rel_err(got["stats"][k], w) <= STATS_REL, k


# ------------------------------------------------------------------ ranks vs one process


@pytest.mark.parametrize("case", ["vps_live_bn", "vis_live_bn", "image_no_positives",
                                  "vps_no_positives", "vps_roi_gt_box", "vps_swin_drop_path"])
def test_two_ranks_equal_one_process(runs, case):
    one, ranks = runs["one"][case], runs["ranks"][case]
    for r in ranks:
        assert r["replayed"] == [True, True]
        assert len(r["losses"]) == len(one["losses"]) == 2
        for got, want in zip(r["losses"], one["losses"]):
            assert set(got) == set(want)
            for k, w in want.items():
                assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)
        for k, v in one["state"].items():
            err = float((r["state"][k] - v).abs().max())
            if k.endswith(("running_mean", "running_var")):
                assert err <= 1e-5 * max(float(v.abs().max()), 1e-12), k
            else:
                assert err <= 1e-6, k
        assert set(r["grads"]) == set(one["grads"])
        for k, g in one["grads"].items():
            scale = float(g.abs().max())
            if k.endswith(".key.bias"):  # zero up to rounding
                scale = float(one["grads"][k[:-len("bias")] + "weight"].abs().max())
            assert float((r["grads"][k] - g).abs().max()) <= 1e-3 * max(scale, 1e-12), k
    # the statistics are the global batch's, so the buffers agree across the
    # ranks without DDP's broadcast; the summed gradients give equal updates
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_the_cases_reach_what_they_check(runs):
    """Live statistics move, the positive-free rows have no positive, the
    roi_gt_box link's last stage takes no gradient, and stochastic depth
    drops rows of the global batch."""
    vis = runs["one"]["vis_live_bn"]["state"]
    start = tvis.KNetVIS(_vis_cfgs()[1], generator=torch.Generator().manual_seed(0),
                         device="cpu").state_dict()
    moved = [k for k in vis if k.endswith("running_mean") and not torch.equal(vis[k], start[k])]
    assert moved and not any(k.startswith(("backbone.bn1.", "backbone.layer1_")) for k in moved)
    cases = _cases(runs["vps_weights"])
    for name in ("image_no_positives", "vps_no_positives"):
        gt = cases[name]["batches"][0].gt
        assert not gt.valid[1].any() and not gt.sem_valid[1].any() and gt.valid[0].any()
    roi = tvps.VideoKNet(cases["vps_roi_gt_box"]["cfg"], device="cpu")
    unused = {n for n, p in roi.named_parameters() if p.requires_grad}
    assert unused - set(runs["one"]["vps_roi_gt_box"]["grads"])


@pytest.mark.parametrize("case", ["vps_live_bn", "vis_live_bn", "image_no_positives",
                                  "vps_no_positives", "vps_roi_gt_box", "vps_swin_drop_path"])
def test_models_declare_the_parameters_no_loss_reaches(runs, case):
    """`leaves_parameters_unused` (DDP looks for unused parameters only
    then) is true exactly where a trainable parameter took no gradient in
    the one-process step."""
    one = runs["one"][case]
    assert one["declares_unused"] == bool(set(one["trainable"]) - set(one["grads"]))


def test_stochastic_depth_draws_the_global_batch():
    """Under a mesh, each rank's draws for [ref; key] are its rows of the
    draws one process makes for the global batch's [ref; key]."""
    full = torch.rand((8,), generator=torch.Generator().manual_seed(0))
    with tmesh.batch_blocks(2):
        for r in range(2):
            with mock.patch.object(tmesh, "_ACTIVE") as active:
                active.get.return_value = DataMesh(r, 2, group=object())
                got = tmesh.batch_uniform(4, torch.Generator().manual_seed(0), "cpu")
            assert torch.equal(got, full.reshape(2, 2, 2)[:, r].reshape(4))


# ------------------------------------------------------------------ mesh and process group


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_takes_the_rows_jax_gives_each_device(world):
    """Rank r's rows of every leaf are the shard JAX's `shard_batch` puts
    on device r of a `data` mesh of `world` devices."""
    rng = np.random.RandomState(0)
    batch = (rng.randn(8, 3, 2).astype(np.float32),
             PanopticGT(*(rng.randn(8, 2).astype(np.float32) for _ in PanopticGT._fields)))
    jm = jmesh.make_mesh(n_data=world, n_model=1, devices=jax.devices()[:world])
    want = jax.tree_util.tree_leaves(jmesh.shard_batch(jm, batch))
    for r in range(world):
        got = jax.tree_util.tree_leaves(tmesh.shard_batch(DataMesh(r, world), batch))
        for g, w in zip(got, want):
            shard = next(s for s in w.addressable_shards if s.device == jm.devices[r, 0])
            np.testing.assert_array_equal(g, np.asarray(shard.data))


def test_mesh_raises_where_jax_cannot_place_the_batch():
    """A batch that does not split over the data axis raises; a mesh that
    does not cover the world raises (one process: world 1); a 2-D mesh
    places rank r where JAX's `make_mesh` puts device r."""
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(DataMesh(0, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="n_model=2"):
        tmesh.make_mesh(n_model=2)
    with pytest.raises(ValueError, match="n_model=2"):
        tdist.global_mesh(n_model=2)
    with pytest.raises(ValueError, match="n_data=2"):
        tmesh.make_mesh(n_data=2)
    assert tmesh.make_mesh() == DataMesh() == tdist.global_mesh()
    jm = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    for r, dev in enumerate(jax.devices()[:4]):
        mesh = DataMesh(r, 4, n_model=2)
        assert jm.devices[mesh.data_index, mesh.model_index] == dev
        assert (mesh.n_data, mesh.n_model) == (jm.shape["data"], jm.shape["model"])


def test_allgather_results_orders_as_jax_does(runs, monkeypatch):
    """Rank 0 gets every rank's list in rank order, the others None; JAX's
    `allgather_results` on rank 0 reads the same part files alike."""
    gather = runs["gather"]
    assert gather[0] == runs["items"][0] + runs["items"][1] and gather[1] is None
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    from jax.experimental import multihost_utils

    monkeypatch.setattr(multihost_utils, "sync_global_devices", lambda name: None)
    tmp = os.path.join(runs["root"], "rest", "gather")
    assert jdist.allgather_results(runs["items"][0], tmp) == gather[0]


def test_a_stop_on_one_rank_stops_every_rank(runs):
    """`any_rank`, which `train_vps` asks at every step boundary with its
    preemption flag: a signal on rank 1 alone stops both ranks at the same
    step; no signal, no stop."""
    assert runs["stop"] == [[True, False], [True, False]]


def test_replicated_gives_every_rank_rank_0s_state(runs):
    """`mesh.replicated` (JAX's replicated train state): parameters and
    buffers of rank 0 on both ranks."""
    for sd in runs["replica"]:
        for k, v in sd.items():
            assert torch.equal(v, torch.ones_like(v)), k


def test_one_process_helpers_are_the_identity():
    x = torch.arange(6.0)
    assert tdist.allgather_results([1, 2]) == [1, 2]
    assert tdist.any_rank(True) and not tdist.any_rank(False)
    assert tdist.initialize("cpu") == torch.device("cpu")  # no torchrun: no group
    assert not torch.distributed.is_initialized()
    assert tmesh.global_sum(x) is x and torch.equal(tmesh.global_mean(x), x.mean())
    assert tmesh.sum_with_grad(x) is x
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tmesh.batch_uniform(3, g, "cpu"),
                       torch.rand((3,), generator=torch.Generator().manual_seed(0)))
    with tmesh.data_parallel(DataMesh(0, 1)):  # no process group: nothing to reduce
        assert tmesh.active_mesh() is None


def test_backend_and_card_per_rank(monkeypatch):
    """NCCL when each rank has a card, gloo on the CPU; ranks that share a
    card raise unless gloo is asked for by name."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tdist._rank_device(cuda, 1, 2, None) == (torch.device("cuda", 1), "nccl")
    assert tdist._rank_device(cuda, 1, 2, "gloo") == (torch.device("cuda", 1), "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share 1 GPU"):
        tdist._rank_device(cuda, 1, 2, None)
    with pytest.raises(ValueError, match="share 1 GPU"):
        tdist._rank_device(cuda, 1, 2, "nccl")
    assert tdist._rank_device(cuda, 1, 2, "gloo") == (torch.device("cuda", 0), "gloo")
    assert tdist._rank_device(torch.device("cpu"), 1, 2, None) == (torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="only gloo"):
        tdist._rank_device(torch.device("cpu"), 1, 2, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no GPU"):
        tdist._rank_device(cuda, 0, 2, None)


# ------------------------------------------------------------------ loaders


def test_vps_loader_ranks_read_their_rows(tmp_path):
    """With a data mesh every rank walks the global batches and loads its
    rows; stacked, the ranks' batches are the one-process loader's."""
    root = str(tmp_path)
    write_kitti_step_tree(root, n_seqs=1, n_frames=6, hw=(24, 40), n_things=3)
    cfg = tconfig.VideoKNetConfig(max_insts=4)

    def batches(mesh):
        ds = tds.KittiStepDVPS(root, ref_seq_index=(-2, -1, 1, 2))
        return list(VPSTrainLoader(ds, cfg, batch_size=4, crop_hw=(24, 40), num_threads=2,
                                   device="cpu", mesh=mesh))

    full = batches(None)
    parts = [batches(DataMesh(r, 2)) for r in range(2)]
    assert len(full) == len(parts[0]) == len(parts[1]) == 1
    for b_full, b0, b1 in zip(full, *parts):
        for f, x0, x1 in zip(jax.tree_util.tree_leaves(tuple(b_full)),
                             jax.tree_util.tree_leaves(tuple(b0)),
                             jax.tree_util.tree_leaves(tuple(b1))):
            assert x0.shape[0] == x1.shape[0] == f.shape[0] // 2
            assert torch.equal(torch.cat([x0, x1]), f)


def test_vis_loader_ranks_read_their_clips(tmp_path):
    ann, img_root = write_ytvis_cocovid(str(tmp_path), n_videos=4, n_frames=4, hw=(24, 40),
                                        max_insts=3, seed=2)
    cfg = dataclasses.replace(tconfig_vis.VISConfig(), num_frames=2, max_insts=3)

    def batches(mesh):
        ds = YouTubeVISDataset(ann, img_root=img_root)
        return list(VISTrainLoader(ds, cfg, batch_size=4, canvas_hw=(32, 48), num_threads=2,
                                   device="cpu", mesh=mesh))

    full, parts = batches(None), [batches(DataMesh(r, 2)) for r in range(2)]
    assert len(full) == 1
    for f, x0, x1 in zip(jax.tree_util.tree_leaves(tuple(full[0])),
                         jax.tree_util.tree_leaves(tuple(parts[0][0])),
                         jax.tree_util.tree_leaves(tuple(parts[1][0]))):
        assert torch.equal(torch.cat([x0, x1]), f)


def test_image_samples_ranks_read_their_rows(tmp_path):
    """`train_image`'s sample iterator: a rank skips the other ranks' rows
    (nothing read) but draws their augmentations, so its rows are the
    one-process run's."""
    import argparse

    from video_knet_tpu_torch.tools.train_image import _iter_samples

    root = str(tmp_path)
    write_kitti_step_tree(root, n_seqs=1, n_frames=4, hw=(24, 40), n_things=3)
    args = argparse.Namespace(dataset="kitti_step", data_root=root, crop=[24, 40])
    cfg = tconfig.KNetConfig(max_insts=4)
    full = list(_iter_samples(args, cfg, np.random.RandomState(0)))
    for r in range(2):
        got = list(_iter_samples(args, cfg, np.random.RandomState(0),
                                 keep=lambda k, r=r: k % 4 // 2 == r))
        assert len(got) == len(full) == 4
        for k, (g, f) in enumerate(zip(got, full)):
            if k % 4 // 2 != r:
                assert g is None
                continue
            np.testing.assert_array_equal(g[0], f[0])
            for a, b in zip(g[1], f[1]):
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ train_vps under two ranks


def _records(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and '"iter"' in line]


def test_train_vps_two_ranks_equal_one_process(runs):
    """Two ranks at 2 images each (2 steps, then 2 more resumed from the
    first epoch's checkpoint) against one process at 4 (4 steps): the same
    records (losses within one unit of their 4th decimal, the log's
    rounding) and final weights within 1e-6."""
    want = _records(runs["single_out"])
    got = _records(runs["cli_outs"][0][0]) + _records(runs["cli_outs"][1][0])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) and (g["epoch"], g["iter"]) == (w["epoch"], w["iter"])
        for k, v in w.items():
            if k not in ("epoch", "iter", "imgs_per_sec"):
                assert abs(g[k] - v) <= 1e-4 * max(abs(v), 1.0) + 1e-4, (k, g[k], v)
    a, b = runs["cli_final"]["ranks"], runs["cli_final"]["single"]
    for k, v in b.items():
        assert float((a[k] - v).abs().max()) <= 1e-6 * max(1.0, float(v.abs().max())), k


def test_train_vps_two_ranks_write_one_log_and_checkpoint(runs):
    """Rank 0 alone prints, logs and checkpoints; rank 1 prints nothing of
    the run; the log holds each step once."""
    assert runs["cli_dirs"] == {"": ["ckpt", "train_log.jsonl"], "ckpt": ["step_1", "step_2"]}
    assert [(r["epoch"], r["iter"]) for r in runs["cli_log"]] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    for epoch, (rank0, rank1) in enumerate(runs["cli_outs"]):
        assert "devices: 2" in rank0 and f"epoch {epoch + 1} done" in rank0
        assert not _records(rank1) and "done" not in rank1 and "devices" not in rank1
