"""The port's training command lines against the JAX package's, on the CPU.

`train_vps`, `train_vis` and `train_image` of both packages run on
one-stage tiny configs over seeded trees, two steps each with
`--log-interval 1` and `--load-from` the same weights (the port's
`save_checkpoint`, JAX's orbax checkpoint from `state_dict_to_flax`). The
JAX runs go in processes of their own (`tests/torch_port_jax_jobs.py`:
tracing a train step holds the GIL for tens of seconds), the longest at
the highest priority, with one-device meshes, JAX's `model.init` returning
the converted variables (its optimizer needs the params tree) and its
`save_checkpoint` keeping the state in the result; the port's runs go on
in this process meanwhile. Equal: the records' keys, epochs and
iterations; losses within 1e-4 relative; the saved parameters within 1e-6
(at lr(0) = 1e-7 under the 1000-step warmup an AdamW step moves a leaf by
about lr, so a gradient sign that flips between the packages cannot move
it past 2 * steps * lr); the eval records equal.

Port only: a resumed run equals an unbroken one bit for bit; SIGTERM after
a step leaves a checkpoint at that step; `--freeze-detector` and `--bf16`
train. Against JAX: the first `--freeze-detector` step against one
`freeze_detector` step of JAX's optimizer from the gradient of JAX's first
`train_vps` step (the port's detector stays bit-equal, its track leaves
within 1e-6 of JAX's, and JAX's detector moves by exactly its raw
gradient: `optax.masked` passes a masked leaf's gradient through to
`apply_updates`); where `--load-from` and `--resume-from` differ from
JAX's by design; the bf16 losses of VPS and VIS (and that the backbone
and neck compute in bf16); `get_flops`.
"""

import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)
import trained_golden_common as jtg
from flax import traverse_util
from torch_port_common import (
    _collect,
    _spawn,
    _tiny_image_cfg,
    _ytvis_tree,
    run_port,
    write_checkpoints,
)

import video_knet_tpu.config as jconfig
import video_knet_tpu.config_vis as jconfig_vis
import video_knet_tpu_torch.config as tconfig
import video_knet_tpu_torch.config_vis as tconfig_vis
import video_knet_tpu_torch.configs as tconfigs
import video_knet_tpu_torch.train.vps as ttvps
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu_torch.models.knet import KNet
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
from video_knet_tpu_torch.tools import get_flops
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.data_check import write_cityscapes_step_tree
from video_knet_tpu_torch.tools.train_check import margin_seed, vis_check_cfg, vis_margin_seed
from video_knet_tpu_torch.train import optim as toptim
from video_knet_tpu_torch.train import vis as ttvis
from video_knet_tpu_torch.utils.checkpoint import load_model_state
from video_knet_tpu_torch.utils import precision as tprec
from video_knet_tpu_torch.utils.convert import flax_names, state_dict_to_flax

HW = (64, 96)
CROP = ["--crop", "64", "96"]
LOSS_REL = 1e-4
PARAM_ABS = 1e-6
BF16_REL = 0.05  # the JAX package's band for bf16 against fp32 (tests/test_train_extras.py)
# The port's bf16 loss against JAX's at the same weights. Readings on the
# direct checks' inputs (PERF.md section 6): |port bf16 - JAX bf16| is
# 6.4e-4 (VPS) and 1.1e-3 (VIS) of JAX's bf16 loss; |port fp32 - JAX bf16|
# 1.6e-4 and 3.0e-3. On an AVX-512 host with bf16 instructions XLA's bf16
# rounds otherwise: 5.3e-4 and 3.6e-4; 6.3e-4 and 1.7e-3. The two bf16
# forwards round in different places (XLA fuses elementwise chains and
# rounds at a fusion's end, PyTorch after every op), so the VPS band cannot
# tell bf16 from fp32: `layer_dtypes` does.
BF16_VS_JAX_REL = 2e-3
# the port's bf16 loss lies apart from its fp32 loss by more than this many
# times its fp32 loss's distance from JAX's (fp32 rounding)
BF16_APART = 100
# FlopCounterMode against XLA's cost_analysis for the one-stage MiT-b0 VPS
# config at 64x96 (measured 2.18 / 2.07 GFLOPs = 1.053; R-50 at 64x96 4.16 /
# 3.97 = 1.048; at 384x1248 the port counts 3.2% less, PERF.md section 6)
FLOPS_RATIO = (1.0, 1.08)
VIS_FRAMES = 2
STEPS_PER_EPOCH = 2  # the VPS tree's 8 train frames at B=4


def _variables(model) -> dict:
    return traverse_util.unflatten_dict(state_dict_to_flax(model, model.state_dict()), sep="/")


def _one_stage(cfg):
    """`cfg` with one kernel-update stage (and one tracker stage for VIS):
    the JAX compiles of the train steps are most of this file's time."""
    kw = dict(num_stages=1, assign_stages=1, stage_loss_weights=(1.0,))
    if hasattr(cfg, "tracker_num_stages"):
        kw.update(tracker_num_stages=1, tracker_assign_stages=1,
                  tracker_stage_loss_weights=(1.0,))
    return dataclasses.replace(cfg, **kw)


def _vis_train_cfg(base):
    """`vis_check_cfg` at one stage over YouTube-VIS 2019's 40 classes (the
    seeded tree's categories)."""
    cfg = _one_stage(vis_check_cfg(base))
    split = dict(num_classes=40, num_thing_classes=40, num_stuff_classes=0)
    return dataclasses.replace(cfg, num_classes=40, rpn=dataclasses.replace(cfg.rpn, **split),
                               head=dataclasses.replace(cfg.head, **split))


def _records(text: str) -> list[dict]:
    out = []
    for line in text.splitlines():
        if line.startswith("{") and '"iter"' in line:
            out.append(json.loads(line))
    return out


def _vps_tree(root: str) -> str:
    """The trained golden's 12 frames: 4-11 in `train`, 0-3 in `val`."""
    tg.write_sequence(root)
    src = os.path.join(root, "video_sequence", "train")
    val = os.path.join(root, "video_sequence", "val")
    os.makedirs(val)
    for f in range(4):
        for kind in ("leftImg8bit", "panoptic"):
            name = f"000000_{f:06d}_{kind}.png"
            os.rename(os.path.join(src, name), os.path.join(val, name))
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' train CLIs over the same trees and weights (JAX's in
    processes of their own), JAX's side of the direct checks, and
    `get_flops` of both."""
    root = str(tmp_path_factory.mktemp("train_cli"))
    vps_root = _vps_tree(os.path.join(root, "kitti"))
    city = os.path.join(root, "city")
    write_cityscapes_step_tree(city, cities=("aachen",), n_images=2, hw=(64, 128))
    write_cityscapes_step_tree(city, cities=("bremen",), n_images=2, hw=(64, 128),
                               split="val", seed=1)
    vis_ann, vis_imgs = _ytvis_tree(os.path.join(root, "ytvis"))

    vps_cfg = (_one_stage(tg.tiny_cfg()), _one_stage(jtg.tiny_cfg()))
    vis_cfg = (_vis_train_cfg(tconfig_vis.VISConfig()), _vis_train_cfg(jconfig_vis.VISConfig()))
    img_cfg = (_one_stage(_tiny_image_cfg(tconfig.KNetConfig())),
               _one_stage(_tiny_image_cfg(jconfig.KNetConfig())))
    mit = ["--backbone", "mit_b0"]
    argv = {
        "train_vps": [*mit, "--data-root", vps_root, "--epochs", "1", "--batch-size", "4",
                      *CROP, "--max-insts", "4", "--log-interval", "1", "--eval-interval", "1",
                      "--eval-max-frames", "2"],
        "train_vis": [*mit, "--ann-file", vis_ann, "--img-root", vis_imgs, "--epochs", "1",
                      "--batch-size", "1", *CROP, "--num-frames", str(VIS_FRAMES),
                      "--log-interval", "1"],
        "train_image": [*mit, "--data-root", city, "--epochs", "1", "--batch-size", "1", *CROP,
                        "--max-insts", "4", "--log-interval", "1"],
    }
    configs = {("video_knet_tpu.config", "kitti_step_video_config"): vps_cfg[1],
               ("video_knet_tpu.config_vis", "youtube_vis_2019_config"): vis_cfg[1],
               ("video_knet_tpu.configs", "knet_s3_r50_fpn_cityscapes_step"): img_cfg[1]}
    tag_of = {"train_vps": "vps", "train_vis": "vis", "train_image": "image"}
    ckpts, models, jobs = {}, {}, {}

    def argv_of(cli, pkg):
        return [*argv[cli], "--work-dir", os.path.join(root, f"{pkg}_{cli}"),
                "--load-from", ckpts[tag_of[cli]][pkg]]

    # each JAX job starts as soon as its inputs exist, the longest first
    try:
        for cli, cls, cfg, seed, jax_model in (
                ("train_vps", VideoKNet, vps_cfg[0], margin_seed(vps_cfg[0], HW)[0],
                 ("video_knet_tpu.models.video.knet_vps", "VideoKNet")),
                ("train_vis", KNetVIS, vis_cfg[0], vis_margin_seed(vis_cfg[0], HW)[0],
                 ("video_knet_tpu.models.vis.knet_vis", "KNetVIS")),
                ("train_image", KNet, img_cfg[0], 0, ("video_knet_tpu.models.knet", "KNet"))):
            tag = tag_of[cli]
            models[tag] = cls(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
            # the job imports while the checkpoints it reads are written here
            ckpts[tag] = {pkg: os.path.join(root, tag, f"{pkg}_ckpt") for pkg in ("port", "jax")}
            ready = os.path.join(root, f"{tag}.ready")
            jobs[cli] = _spawn(root, cli, dict(job="cli", name=cli, argv=argv_of(cli, "jax"),
                                               configs=configs, keep_grads=cli == "train_vps",
                                               inits={jax_model: _variables(models[tag])},
                                               wait_for=ready),
                               nice=0 if cli == "train_vps" else 5)
            assert write_checkpoints(models[tag], os.path.join(root, tag)) == ckpts[tag]
            open(ready, "w").close()
        direct = _direct_models()
        vis_batch = ttvis.make_synthetic_batch(direct["vis"].cfg, 1, HW, device="cpu")
        jobs["direct_vps"] = _spawn(root, "direct_vps", dict(
            job="direct_vps", vps_cfg=vps_cfg[1], vps_vars=_variables(direct["vps"]), hw=HW))
        jobs["direct_vis"] = _spawn(root, "direct_vis", dict(
            job="direct_vis", vis_cfg=_one_stage(vis_check_cfg(jconfig_vis.VISConfig())),
            vis_vars=_variables(direct["vis"]), vis_clip=vis_batch.clip.numpy(),
            vis_gt=[x.numpy() for x in vis_batch.gt]))
        flops_argv = ["--shape", *map(str, HW), *mit]
        flops_cfg = (_one_stage(tconfig.kitti_step_video_config()),
                     _one_stage(jconfig.kitti_step_video_config()))
        flops_model = VideoKNet(dataclasses.replace(flops_cfg[0], backbone="mit_b0"),
                                generator=torch.Generator().manual_seed(0), device="cpu")
        jobs["flops"] = _spawn(root, "flops", dict(
            job="cli", name="get_flops", argv=flops_argv,
            configs={("video_knet_tpu.config", "kitti_step_video_config"): flops_cfg[1]},
            inits={("video_knet_tpu.models.video.knet_vps", "VideoKNet"):
                   _variables(flops_model)}))
        # the still runs: R-50 (the tiny model has no BatchNorm), no forward
        bn_model = VideoKNet(dataclasses.replace(vps_cfg[0], backbone="resnet50"),
                             generator=torch.Generator().manual_seed(0), device="cpu")
        bn_ckpt = write_checkpoints(_other_bn_stats(bn_model), os.path.join(root, "vps_bn"))
        bn_inits = {("video_knet_tpu.models.video.knet_vps", "VideoKNet"): _variables(bn_model)}
        still = [*_no_eval(argv["train_vps"]), "--backbone", "resnet50", "--epochs", "2",
                 "--log-interval", "100"]
        jobs["still"] = _spawn(root, "still", dict(
            job="cli", name="train_vps", configs=configs, inits=bn_inits, still=True,
            argv=[*still, "--load-from", bn_ckpt["jax"],
                  "--work-dir", os.path.join(root, "jax_still")]))
        jobs["still_resumed"] = _spawn(root, "still_resumed", dict(
            job="cli", name="train_vps", configs=configs, inits=bn_inits, still=True,
            resume_step=STEPS_PER_EPOCH, argv=[*still, "--resume-from", bn_ckpt["jax"],
                                               "--work-dir", os.path.join(root, "jax_resumed")]))
        is_stat = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
        bn = dict(init={k: v for k, v in bn_model.state_dict().items() if is_stat(k)},
                  loaded={k: v for k, v in load_model_state(bn_ckpt["port"]).items()
                          if is_stat(k)},
                  jax_init={k[len("batch_stats/"):]: v for k, v in state_dict_to_flax(
                      bn_model, bn_model.state_dict()).items() if k.startswith("batch_stats/")})
        del bn_model, bn_inits

        with pytest.MonkeyPatch.context() as mp:
            for module, attr, value in (
                    (tconfig, "kitti_step_video_config", lambda: vps_cfg[0]),
                    (tconfig_vis, "youtube_vis_2019_config", lambda: vis_cfg[0]),
                    (tconfigs, "knet_s3_r50_fpn_cityscapes_step", lambda: img_cfg[0])):
                mp.setattr(module, attr, value)
            port = {cli: run_port(cli, argv_of(cli, "port")) for cli in argv}
            mp.setattr(tconfig, "kitti_step_video_config", lambda: flops_cfg[0])
            port["flops"] = run_port("get_flops", flops_argv)
        own = _port_only(root, argv["train_vps"], vps_cfg[0], ckpts["vps"]["port"],
                         argv_of("train_image", "port"), img_cfg[0])
        own.update(_port_still(root, still, vps_cfg[0], bn_ckpt["port"]))
        r50_params = _jax_r50_params()
        jax_out = {k: _collect(*job) for k, job in jobs.items()}
        shutil.rmtree(os.path.join(root, "vps_bn"))
    finally:
        for proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return dict(root=root, jax=jax_out, port=port, models=models, direct=direct,
                vis_batch=vis_batch, own=own, r50_params=r50_params, bn=bn)


def _no_eval(argv: list) -> list:
    """`argv` without `--eval-interval N --eval-max-frames N`."""
    argv = list(argv)
    i = argv.index("--eval-interval")
    del argv[i:i + 4]
    return argv


def _other_bn_stats(model):
    """A copy of `model` whose BatchNorm running statistics are not the
    init's (seeded)."""
    import copy

    model = copy.deepcopy(model)
    g = torch.Generator().manual_seed(1)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.add_(0.1 * torch.randn(buf.shape, generator=g))
        elif name.endswith("running_var"):
            buf.mul_(1.0 + torch.rand(buf.shape, generator=g))
    return model


def _jax_r50_params() -> int:
    """The JAX package's parameter count of its default VPS model (R-50),
    from the init's shapes alone."""
    model = JVideoKNet(jconfig.VideoKNetConfig(), train=False)
    x = jnp.zeros((1, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)
    return sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes["params"]))


def _direct_models() -> dict:
    """The weights of the direct checks: the tiny VPS and VIS configs at one
    stage, with seeds whose hard-threshold inputs keep a margin on the
    synthetic batches (`train_check.margin_seed`, `vis_margin_seed`)."""
    vps, vis = _one_stage(tg.tiny_cfg()), _one_stage(vis_check_cfg(tconfig_vis.VISConfig()))
    return {"vps": VideoKNet(vps, generator=torch.Generator().manual_seed(
                margin_seed(vps, HW)[0]), device="cpu"),
            "vis": KNetVIS(vis, generator=torch.Generator().manual_seed(
                vis_margin_seed(vis, HW)[0]), device="cpu")}


# ------------------------------------------------------------------ against the JAX CLIs


def _assert_records_match(got: list, want: list, what: str) -> None:
    """Same keys (but the wall-clock rate), epochs and iterations; losses
    within LOSS_REL relative, plus one unit of the records' 4th decimal
    (both sides round to it)."""
    assert len(got) == len(want) == 2, (what, got, want)
    for a, b in zip(got, want):
        a, b = dict(a), dict(b)
        a.pop("imgs_per_sec", None), b.pop("imgs_per_sec", None)
        assert set(a) == set(b), (what, sorted(a), sorted(b))  # JAX's dicts come back sorted
        assert (a.pop("epoch"), a.pop("iter")) == (b.pop("epoch"), b.pop("iter"))
        for k, v in b.items():
            assert abs(a[k] - v) <= LOSS_REL * abs(v) + 1e-4, (what, k, a[k], v)


def _assert_params_match(model, port_dir: str, want: dict, init) -> None:
    """The port's saved parameters within PARAM_ABS of JAX's (flat) leaf by
    leaf; some moved from `init`."""
    sd = load_model_state(os.path.join(port_dir, "ckpt", "step_1"))
    got = {k[len("params/"):]: v for k, v in state_dict_to_flax(model, sd).items()
           if k.startswith("params/")}
    assert set(got) == set(want)
    for k, v in want.items():
        err = float(np.abs(got[k] - np.asarray(v)).max()) if v.size else 0.0
        assert err <= PARAM_ABS, (k, err)
    start = {k[len("params/"):]: v for k, v in init.items() if k.startswith("params/")}
    assert any(not np.array_equal(got[k], start[k]) for k in got)


@pytest.mark.parametrize("cli", ["train_vps", "train_vis", "train_image"])
def test_train_cli_matches_jax(runs, cli):
    """Two steps of each train CLI of both packages from the same weights:
    the records, the saved parameters and the eval records agree."""
    got, want = runs["port"][cli], runs["jax"][cli]["out"]
    _assert_records_match(_records(got), _records(want), cli)
    tag = {"train_vps": "vps", "train_vis": "vis", "train_image": "image"}[cli]
    model = runs["models"][tag]
    port_dir = os.path.join(runs["root"], f"port_{cli}")
    _assert_params_match(model, port_dir,
                         runs["jax"][cli]["params"][os.path.join(runs["root"], f"jax_{cli}")],
                         state_dict_to_flax(model, model.state_dict()))
    if cli == "train_vps":
        with open(os.path.join(port_dir, "train_log.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        assert logged[:2] == _records(got)
        evals = [line for line in got.splitlines() if line.startswith("eval:")]
        assert evals == [line for line in want.splitlines() if line.startswith("eval:")]
        rec = json.loads(evals[0][len("eval:"):])
        assert logged[2] == {"eval": rec} and rec["frames"] == 2


# ------------------------------------------------------------------ the port's own runs


def _port_vps(base: list, cfg, argv: list, work_dir: str) -> str:
    """The port's train_vps under `cfg`, on `base`'s arguments without eval."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "kitti_step_video_config", lambda: cfg)
        return run_port("train_vps", [*_no_eval(base), "--work-dir", work_dir, *argv])


def _port_still(root: str, still: list, cfg, load: str) -> dict:
    """The port's train_vps with a step that only counts (the model and
    the optimizer stay as they are) and keeps a digest of each batch's
    images: two epochs from `load`, then
    the second again, resumed from the first's checkpoint."""
    batches = []

    def still_step(state, batch, *args, **kwargs):
        batches.append(hashlib.sha1(batch.img.numpy().tobytes()).hexdigest())
        return dataclasses.replace(state, step=state.step + 1), {}

    work_dir = os.path.join(root, "port_still")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttvps, "train_step", still_step)
        mp.setattr(tconfig, "kitti_step_video_config", lambda: cfg)
        out = run_port("train_vps", [*still, "--load-from", load, "--work-dir", work_dir])
        unbroken = list(batches)
        saved = load_model_state(os.path.join(work_dir, "ckpt", "step_2"))
        batches.clear()
        run_port("train_vps", [*still, "--resume-from",
                               os.path.join(work_dir, "ckpt", "step_1"), "--work-dir", work_dir])
    shutil.rmtree(work_dir)  # R-50 checkpoints
    return dict(still_out=out, still_batches=unbroken, still_resumed=list(batches),
                still_saved=saved)


def _port_only(root: str, base: list, cfg, load: str, image_argv: list, image_cfg) -> dict:
    """The port-only CLI runs, made while JAX's jobs run: two epochs straight
    and one + a resumed one; a SIGTERM after the first step and its resume;
    `--freeze-detector`; `--bf16`; `train_image` with eval."""
    out = {}
    load = ["--load-from", load]
    straight, split = os.path.join(root, "straight"), os.path.join(root, "split")
    out["straight"] = _port_vps(base, cfg, [*load, "--epochs", "2"], straight)
    _port_vps(base, cfg, [*load, "--epochs", "1"], split)
    out["resumed"] = _port_vps(base, cfg, ["--epochs", "2", "--resume-from",
                                           os.path.join(split, "ckpt", "step_1")], split)
    out["ckpts"] = [torch.load(os.path.join(d, "ckpt", "step_2", "checkpoint.pt"),
                               weights_only=True) for d in (straight, split)]

    pre = os.path.join(root, "preempt")
    step = ttvps.train_step

    def first_then_term(state, batch, *a, **k):
        res = step(state, batch, *a, **k)
        if res[0].step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return res

    handler = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttvps, "train_step", first_then_term)
        out["preempted"] = _port_vps(base, cfg, load, pre)
    out["handler_restored"] = signal.getsignal(signal.SIGTERM) is handler
    ckpt = os.path.join(pre, "ckpt", "step_1")
    out["preempt_step"] = torch.load(os.path.join(ckpt, "checkpoint.pt"),
                                     weights_only=True)["step"]
    out["preempt_resumed"] = _port_vps(base, cfg, ["--resume-from", ckpt], pre)
    out["resumed_step"] = torch.load(os.path.join(ckpt, "checkpoint.pt"),
                                     weights_only=True)["step"]

    first = {}

    def keep_first(state, batch, *a, **k):
        res = step(state, batch, *a, **k)
        first.setdefault("params", {n: p.detach().clone()
                                    for n, p in res[0].model.named_parameters()})
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttvps, "train_step", keep_first)
        _port_vps(base, cfg, [*load, "--freeze-detector"], os.path.join(root, "freeze"))
    out["frozen"] = load_model_state(os.path.join(root, "freeze", "ckpt", "step_1"))
    out["frozen_first"] = first["params"]
    out["bf16"] = _port_vps(base, cfg, [*load, "--bf16"], os.path.join(root, "bf16"))

    argv = list(image_argv)
    argv[argv.index("--work-dir") + 1] = os.path.join(root, "image_eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfigs, "knet_s3_r50_fpn_cityscapes_step", lambda: image_cfg)
        out["image_eval"] = run_port("train_image", [*argv, "--eval-interval", "1",
                                                     "--eval-max-images", "2"])
    out["r50_params"] = get_flops.count("vps", *HW, "resnet50", torch.device("cpu"))[1]
    return out


def test_train_vps_resume_equals_an_unbroken_run(runs):
    """Two epochs straight, and one epoch then `--resume-from` its
    checkpoint for the second: the second epoch's records and the final
    parameters and moments equal bit for bit."""
    own = runs["own"]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "imgs_per_sec"}  # noqa: E731
                          for r in recs]
    assert len(_records(own["straight"])) == 4
    assert strip(_records(own["resumed"])) == strip(_records(own["straight"]))[2:]
    a, b = own["ckpts"]
    assert a["step"] == b["step"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in a["adamw"]["state"].items():
        for name, t in v.items():
            assert torch.equal(t, b["adamw"]["state"][k][name]), (k, name)


def test_train_vps_preemption_checkpoints_the_step(runs):
    """SIGTERM during the first step: the step finishes, `ckpt/step_1`
    holds step 1, the run returns with the old handler back; `--resume-from`
    it continues the count (the loop restarts the epoch, as the JAX loop
    does)."""
    own = runs["own"]
    assert own["handler_restored"]
    assert ("preemption checkpoint written; exiting" in own["preempted"]
            and not _records(own["preempted"]))
    assert own["preempt_step"] == 1
    assert [r["iter"] for r in _records(own["preempt_resumed"])] == [1, 2]
    assert own["resumed_step"] == 3


def test_train_vps_freeze_detector_and_bf16(runs):
    """`--freeze-detector`: every detector parameter saved bit-equal to the
    loaded weights, every track / link parameter moved. `--bf16`: finite
    losses, the first step's total within 5% of the fp32 run's on the same
    batch."""
    model = runs["models"]["vps"]
    got = runs["own"]["frozen"]
    trainable = {k for k, v in toptim.frozen_mask(model, True).items() if v}
    assert trainable
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v) != (k in trainable), k
    recs = _records(runs["own"]["bf16"])
    fp32 = _records(runs["port"]["train_vps"])[0]["total_loss"]
    assert len(recs) == 2 and all(np.isfinite(list(r.values())).all() for r in recs)
    assert abs(recs[0]["total_loss"] - fp32) <= BF16_REL * fp32


def test_train_image_evaluates_the_val_split(runs):
    """`train_image --eval-interval 1`: the per-class PQ table and the JSON
    line of the scalars after the epoch, over `--eval-max-images`."""
    out = runs["own"]["image_eval"]
    lines = out[out.index("epoch 1 done"):].splitlines()[1:]
    assert lines[-2].startswith("ALL") and len(lines) == 22, lines
    rec = json.loads(lines[-1])
    assert rec["epoch"] == 1 and rec["eval"]["images"] == 2 and "PQ" in rec["eval"]


# ------------------------------------------------------------------ direct checks


def test_freeze_detector_step_matches_jax(runs):
    """The first step of `train_vps --freeze-detector` from the loaded
    weights: the port's detector leaves stay bit-equal and its track leaves
    land within 1e-6 of one `freeze_detector` step of JAX's optimizer from
    the gradient of JAX's first `train_vps` step (the same weights and
    batch); JAX's detector leaves move by exactly their raw gradient (the
    `optax.masked` pass-through the port does not copy; ROADMAP section
    3)."""
    model = runs["models"]["vps"]
    jd = runs["jax"]["train_vps"]["first"]
    names = flax_names(model, dict(model.named_parameters()))
    got = runs["own"]["frozen_first"]
    after = {k[len("params/"):]: v for k, v in state_dict_to_flax(model, got).items()}
    trainable = toptim.frozen_mask(model, True)
    moved_by_grad = 0
    for k, p in model.named_parameters():
        leaf = names[k][len("params/"):]
        if trainable[k]:
            assert float(np.abs(after[leaf] - jd["stepped"][leaf]).max()) <= PARAM_ABS, k
        else:
            assert torch.equal(got[k], p), k
            np.testing.assert_array_equal(jd["stepped"][leaf],
                                          jd["params"][leaf] + jd["grads"][leaf], err_msg=k)
            moved_by_grad += bool(np.any(jd["grads"][leaf] != 0))
    assert moved_by_grad > 0 and any(trainable.values())


def test_bf16_losses_match_jax(runs):
    """VPS and VIS with `bf16_train`: every convolution and dense layer of
    the backbone and neck computes in bf16 (fp32 without it); the port's
    loss within 5% of its fp32 loss and within BF16_VS_JAX_REL of JAX's bf16
    loss at the same weights; on VIS the bf16 loss also lies nearer JAX's
    bf16 loss than the fp32 loss does, and BF16_APART times farther from the
    fp32 loss than the fp32 rounding of the two packages (a bf16 run that
    computed fp32 fails both, whatever the host's bf16 arithmetic); the
    gradients fp32, the masters untouched by the forward. `pytest -s`
    prints the readings."""
    cases = (("vps", runs["direct"]["vps"], ttvps.make_vps_loss_fn,
              ttvps.make_synthetic_batch(runs["direct"]["vps"].cfg, 1, HW, device="cpu")),
             ("vis", runs["direct"]["vis"], ttvis.make_vis_loss_fn, runs["vis_batch"]))
    for what, model, make_loss, batch in cases:
        jd = runs["jax"][f"direct_{what}"]
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with tprec.layer_dtypes(model) as dtypes32:
            t32 = float(make_loss(model, model.cfg)(batch)[0].detach())
        with tprec.layer_dtypes(model) as dtypes16:
            loss16, _ = make_loss(model, dataclasses.replace(model.cfg, bf16_train=True))(batch)
        assert dtypes32 and set(dtypes32) == set(dtypes16), what
        assert all(d == {torch.float32} for d in dtypes32.values()), (what, dtypes32)
        assert all(d == {torch.bfloat16} for d in dtypes16.values()), (what, dtypes16)
        t16 = float(loss16.detach())
        print(f"{what}: port fp32 {t32!r} bf16 {t16!r}; JAX fp32 {jd['t32']!r} bf16 "
              f"{jd['t16']!r}; |port bf16 - JAX bf16| / JAX bf16 "
              f"{abs(t16 - jd['t16']) / jd['t16']:.3e}, |port fp32 - JAX bf16| / JAX bf16 "
              f"{abs(t32 - jd['t16']) / jd['t16']:.3e}, |JAX bf16 - JAX fp32| / JAX fp32 "
              f"{abs(jd['t16'] - jd['t32']) / jd['t32']:.3e}")
        assert abs(t16 - t32) <= BF16_REL * t32, (what, t16, t32)
        assert abs(t16 - jd["t16"]) <= BF16_VS_JAX_REL * jd["t16"], (what, t16, jd["t16"])
        if what == "vis":
            assert abs(t16 - jd["t16"]) < abs(t32 - jd["t16"]), (what, t16, t32, jd["t16"])
            assert abs(t16 - t32) > BF16_APART * abs(t32 - jd["t32"]), (what, t16, t32,
                                                                          jd["t32"])
        loss16.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        assert grads and all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                             for g in grads), what
        model.zero_grad(set_to_none=True)
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), (what, k)


def test_train_vps_load_and_resume_where_jax_differs(runs):
    """Two deliberate departures from JAX's train_vps (ROADMAP section 3),
    with JAX's side asserted so that a change there shows. Both packages
    run two epochs with a step that only counts. `--load-from`
    a checkpoint whose BatchNorm statistics are not the init's: the port
    keeps them, as the reference's load_checkpoint does; JAX keeps the
    init's (it merges `loaded["params"]` only). `--resume-from` the end of
    epoch 1: the port's resumed epoch sees the unbroken run's second
    epoch's batches (`ThreadedLoader.skip_epochs`); JAX's sees its first
    epoch's again (a fresh loader starts at epoch 0)."""
    own, root = runs["own"], runs["root"]
    unbroken, resumed = runs["jax"]["still"], runs["jax"]["still_resumed"]
    assert f"steps/epoch: {STEPS_PER_EPOCH}" in own["still_out"]
    spe = STEPS_PER_EPOCH
    for batches in (own["still_batches"], unbroken["batches"]):
        assert len(batches) == 2 * spe and batches[:spe] != batches[spe:]
    assert own["still_batches"] == unbroken["batches"]  # the two loaders agree bit for bit
    assert own["still_resumed"] == own["still_batches"][spe:]
    assert resumed["batches"] == unbroken["batches"][:spe]

    bn = runs["bn"]
    assert bn["loaded"] and set(bn["loaded"]) == set(bn["init"])
    for k, v in bn["loaded"].items():
        assert not torch.equal(v, bn["init"][k]) and torch.equal(own["still_saved"][k], v), k
    saved = unbroken["batch_stats"][os.path.join(root, "jax_still")]
    assert bn["jax_init"] and set(saved) == set(bn["jax_init"])
    for k, v in bn["jax_init"].items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)


def test_get_flops_matches_jax(runs):
    """The default VPS config at one stage with MiT-b0 at 64x96 (JAX's tool
    takes 256-channel heads only): the model and params lines equal JAX's,
    GFLOPs within FLOPS_RATIO of XLA's count; the default R-50 VPS model's
    parameter count equals JAX's exactly (39,063,948)."""
    got, want = runs["port"]["flops"].splitlines(), runs["jax"]["flops"]["out"].splitlines()
    assert got[0] == want[0] == f"model=vps input={HW[0]}x{HW[1]}"
    assert got[2] == want[2]
    ratio = float(got[1].split()[1]) / float(want[1].split()[1])
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], (got[1], want[1])
    assert runs["own"]["r50_params"] == runs["r50_params"] == 39_063_948
