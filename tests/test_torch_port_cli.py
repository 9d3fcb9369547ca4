"""The port's command-line entry points against the JAX package's, on the CPU.

Each serving CLI of `video_knet_tpu_torch/tools/` and its counterpart in the
repo root's `tools/` run in process over the same seeded dataset tree with
the same weights: the port's checkpoint written by its own
`save_checkpoint`, JAX's orbax checkpoint by
`video_knet_tpu.utils.checkpoint.save_checkpoint` from `state_dict_to_flax`
of the same model. Small configs come in by monkeypatching the config
factory each CLI imports inside `main` (the trained tiny model's for the
KITTI-STEP CLIs, MiT-b0 under 64-channel heads for the others), and the JAX
CLIs' own init (`model.init`, ~40 s eagerly for the tiny model on the CPU)
by an empty params tree: every leaf comes from the checkpoint, as
`merge_params` lays it over the init.

Equal: the decoded `_cat` / `_ins` / `final` / depth PNGs bit for bit (the
two packages write PNG bytes with different encoders), the COCO results
JSON entry for entry, the printed metric lines as strings. The eval CLIs
run on seeded prediction and GT trees in each `--ann-mode`.
"""

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import io
import json
import os
import re
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)
import trained_golden_common as jtg
from flax import traverse_util

# every module the JAX CLIs import inside `main`, imported here once, so that
# their runs in threads import nothing
import video_knet_tpu.config as jconfig
import video_knet_tpu.configs as jconfigs
import video_knet_tpu.data.datasets  # noqa: F401
import video_knet_tpu.data.panoptic_png  # noqa: F401
import video_knet_tpu.data.transforms  # noqa: F401
import video_knet_tpu.data.tta  # noqa: F401
import video_knet_tpu.eval.coco_instance  # noqa: F401
import video_knet_tpu.eval.miou  # noqa: F401
import video_knet_tpu.models.video.inference  # noqa: F401
import video_knet_tpu.ops.panoptic  # noqa: F401
import video_knet_tpu.train.eval_hook  # noqa: F401
import video_knet_tpu_torch.config as tconfig
import video_knet_tpu_torch.configs as tconfigs
from video_knet_tpu.models.knet import KNet as JKNet
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu.utils import checkpoint as jck
from video_knet_tpu_torch.data.datasets import KittiStepDVPS
from video_knet_tpu_torch.data.panoptic_png import load_png, save_png
from video_knet_tpu_torch.data.transforms import keep_ratio_resize_pad
from video_knet_tpu_torch.models.knet import KNet
from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.tools.train_check import image_check_cfg
from video_knet_tpu_torch.utils.checkpoint import save_checkpoint
from video_knet_tpu_torch.utils.convert import state_dict_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ["--size", "64", "128"]  # keep-ratio: 64x96 content, padded on the right
TRACKERS = ("quasi_dense", "quasi_dense_host", "unitrack", "tao", "simple", "overlap")
COCO_CATS = (1, 3, 7, 9, 12)
WEIGHT_SEED = 0


# ------------------------------------------------------------------ running


def _no_init(self, *args, **kwargs):
    """The JAX CLIs' `model.init`, replaced: an empty params tree, which the
    checkpoint's leaves fill through `merge_params`."""
    return {"params": {}}


def _own_argv_and_stdout(mod, argv: list, out: io.StringIO) -> None:
    """Give a CLI module instance its own argv and standard output: its
    `argparse` parses `argv`, its `print` writes to `out` (module globals,
    so runs in several threads do not share `sys.argv` or `sys.stdout`)."""
    class Parser(argparse.ArgumentParser):
        def parse_args(self, args=None, namespace=None):
            return super().parse_args(argv if args is None else args, namespace)

    mod.argparse = types.SimpleNamespace(ArgumentParser=Parser)
    mod.print = functools.partial(print, file=out)


def run_jax(name: str, argv: list) -> str:
    """A fresh instance of the root `tools/{name}.py` run in process; its
    printed output. The JAX models' `init` and any config factory must be
    patched by the caller (`JAX_PATCHES`)."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    _own_argv_and_stdout(mod, argv, out)
    mod.main()
    return out.getvalue()


def run_port(name: str, argv: list, device=("--device", "cpu")) -> str:
    """The port's CLI `name` in process; its printed output."""
    mod = importlib.import_module(f"video_knet_tpu_torch.tools.{name}")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "print", functools.partial(print, file=out), raising=False)
        mod.main([*argv, *device])
    return out.getvalue()


def write_checkpoints(model, root) -> dict:
    """{"port": its save_checkpoint directory, "jax": an orbax directory of
    the same weights in flax's layouts}."""
    port = save_checkpoint(os.path.join(root, "port_ckpt"), model)
    flat = state_dict_to_flax(model, model.state_dict())
    tree = traverse_util.unflatten_dict(flat, sep="/")
    jax_dir = jck.save_checkpoint(os.path.join(root, "jax_ckpt"), tree)
    return {"port": port, "jax": jax_dir}


def pngs(out_dir) -> dict:
    """{relative path: decoded array} of every PNG under `out_dir`."""
    found = {}
    for d, _, files in os.walk(out_dir):
        for f in files:
            if f.endswith(".png"):
                path = os.path.join(d, f)
                found[os.path.relpath(path, out_dir)] = load_png(path)
    return found


def assert_same_pngs(got_dir, want_dir, expect: int) -> dict:
    got, want = pngs(got_dir), pngs(want_dir)
    assert sorted(got) == sorted(want) and len(got) == expect, (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)
    return got


def masked(text: str) -> str:
    """A CLI's output with its wall-clock times and output paths masked."""
    text = re.sub(r"in [\d.]+s -> \S+", "in <t>s -> <out>", text)
    return re.sub(r"[\d.]+ fps", "<fps> fps", text)


# ------------------------------------------------------------------ trees


def _kitti_tree(root) -> str:
    """Two sequences of the trained golden's frames in `video_sequence/val`:
    frames 0-3 (A and B) and frames 11, 10, 9 (A and C), so a run crosses a
    sequence boundary."""
    tg.write_sequence(root)
    src = os.path.join(root, "video_sequence", "train")
    val = os.path.join(root, "video_sequence", "val")
    os.makedirs(val)
    for s, frames in ((0, (0, 1, 2, 3)), (1, (11, 10, 9))):
        for f, g in enumerate(frames):
            for kind in ("leftImg8bit", "panoptic"):
                os.rename(os.path.join(src, f"000000_{g:06d}_{kind}.png"),
                          os.path.join(val, f"{s:06d}_{f:06d}_{kind}.png"))
    return root


def _tiny_vps_cfg(base, gates_at_zero=False, split=None):
    """The trained tiny config of either package (`base` its `tiny_cfg()`),
    with another (things, stuff) split and the score gates at zero."""
    cfg = base
    if split is not None:
        t, s = split
        kw = dict(num_classes=t + s, num_thing_classes=t, num_stuff_classes=s)
        cfg = dataclasses.replace(cfg, num_thing_classes=t, num_stuff_classes=s,
                                  rpn=dataclasses.replace(cfg.rpn, **kw),
                                  head=dataclasses.replace(cfg.head, **kw))
    if gates_at_zero:
        cfg = dataclasses.replace(
            cfg, test=dataclasses.replace(cfg.test, instance_score_thr=0.0),
            tracker=dataclasses.replace(cfg.tracker, init_score_thr=0.0, obj_score_thr=0.0,
                                        match_score_thr=0.05))
    return cfg


def _tiny_image_cfg(base, instance: bool = False):
    """MiT-b0 under 64-channel heads with the FPN neck (`image_check_cfg`),
    20 proposals; KITTI-STEP's 2 thing + 17 stuff classes, or the
    COCO instance form with one class a category."""
    cfg = image_check_cfg(base, instance=instance, deformable=False)
    t, s = (len(COCO_CATS), 0) if instance else (2, 17)
    kw = dict(num_classes=t + s, num_thing_classes=t, num_stuff_classes=s)
    return dataclasses.replace(
        cfg, num_proposals=20, num_thing_classes=t, num_stuff_classes=s,
        rpn=dataclasses.replace(cfg.rpn, num_proposals=20, **kw),
        head=dataclasses.replace(cfg.head, **kw),
        test=dataclasses.replace(cfg.test, max_per_img=20))


# ------------------------------------------------------------------ test_step


TTA = ["--tta-scales", "0.75", "1.0", "1.25", "--tta-flip"]


def _coco_tree(root) -> str:
    """Three seeded PNG images and their COCO image list (one listed at
    another size, one without a size), five categories."""
    img_root = os.path.join(root, "imgs")
    os.makedirs(img_root)
    rng = np.random.RandomState(0)
    images = []
    for i, hw in enumerate(((60, 90), (70, 80), (64, 96))):
        img = np.full((*hw, 3), 90, np.uint8)
        for _ in range(4):
            y, x = rng.randint(0, hw[0] - 20), rng.randint(0, hw[1] - 20)
            img[y:y + 20, x:x + 20] = rng.randint(0, 256, 3)
        save_png(os.path.join(img_root, f"{i}.png"), img)
        entry = {"id": 10 + i, "file_name": f"{i}.png"}
        if i == 1:
            entry.update(height=35, width=40)
        elif i == 0:
            entry.update(height=hw[0], width=hw[1])
        images.append(entry)
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": [],
                   "categories": [{"id": c} for c in COCO_CATS]}, f)
    return ann


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """Every serving CLI of both packages over the same trees and weights.

    The trained tiny model over the KITTI-STEP tree: `test_step` plain at
    64x128 and with TTA at 64x96 (scales 0.75 / 1.0 / 1.25 and flip),
    `test_vss`; random weights: `test_dvps` (SemKITTI's 8 thing + 11 stuff
    classes, score gates at zero), `test_image` (the tiny image config) and
    `test_coco_instance`. The JAX runs go in threads (XLA compiles outside
    the GIL), each CLI module instance with its own argv and output; the JAX
    `test_step`'s TTA function is kept (`jax_tta`) for the direct checks."""
    import video_knet_tpu.data.tta as jtta
    from test_dvps_e2e import _write_fake_semkitti

    root = str(tmp_path_factory.mktemp("cli_serving"))
    kitti = _kitti_tree(os.path.join(root, "kitti"))
    semkitti = str(_write_fake_semkitti(tmp_path_factory.mktemp("cli_semkitti"), n_frames=4))
    ann = _coco_tree(os.path.join(root, "coco"))
    gen = lambda: torch.Generator().manual_seed(WEIGHT_SEED)  # noqa: E731
    cfgs = {"dvps": (_tiny_vps_cfg(tg.tiny_cfg(), True, (8, 11)),
                     _tiny_vps_cfg(jtg.tiny_cfg(), True, (8, 11))),
            "image": (_tiny_image_cfg(tconfig.KNetConfig()),
                      _tiny_image_cfg(jconfig.KNetConfig())),
            "coco": (_tiny_image_cfg(tconfig.KNetConfig(), instance=True),
                     _tiny_image_cfg(jconfig.KNetConfig(), instance=True))}
    ckpts = {"kitti": write_checkpoints(tg.tiny_model("cpu"), os.path.join(root, "k")),
             "dvps": write_checkpoints(VideoKNet(cfgs["dvps"][0], generator=gen(), device="cpu"),
                                       os.path.join(root, "d")),
             **{k: write_checkpoints(KNet(cfgs[k][0], generator=gen(), device="cpu"),
                                     os.path.join(root, k)) for k in ("image", "coco")}}
    mit = ["--backbone", "mit_b0"]
    step = ["--data-root", kitti, *mit]
    runs = {  # tag: (cli, argv, checkpoint, writes an --out directory)
        "step": ("test_step", [*step, *SIZE], "kitti", True),
        "step_tta": ("test_step", [*step, "--size", "64", "96", *TTA], "kitti", True),
        "vss": ("test_vss", [*step, "--size", "64", "96", "--vc-windows", "2", "4", "8"],
                "kitti", False),
        "dvps": ("test_dvps", ["--data-root", semkitti, *mit, *SIZE, "--max-frames", "3"],
                 "dvps", True),
        "image": ("test_image", [*step, *SIZE, "--max-insts", "4", "--max-images", "5"],
                  "image", False),
        "coco": ("test_coco_instance", ["--ann-file", ann, "--img-root",
                                        os.path.join(root, "coco", "imgs"), *mit, *SIZE,
                                        "--score-thr", "0.05"], "coco", True),
    }
    made = []
    make = jtta.make_tta_semantic_fn

    def recorded(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    def argv_of(tag, pkg):
        cli, argv, ck, writes = runs[tag]
        out = ["--out", os.path.join(root, f"{pkg}_{tag}")] if writes else []
        return [*argv, *out, "--checkpoint", ckpts[ck][pkg]]

    with pytest.MonkeyPatch.context() as mp:
        for module, attr, value in (
                (JVideoKNet, "init", _no_init), (JKNet, "init", _no_init),
                (jtta, "make_tta_semantic_fn", recorded),
                (jconfig, "kitti_step_video_config", jtg.tiny_cfg),
                (tconfig, "kitti_step_video_config", tg.tiny_cfg),
                (jconfig, "semkitti_video_config", lambda: cfgs["dvps"][1]),
                (tconfig, "semkitti_video_config", lambda: cfgs["dvps"][0]),
                (jconfigs, "knet_s3_r50_fpn_cityscapes_step", lambda: cfgs["image"][1]),
                (tconfigs, "knet_s3_r50_fpn_cityscapes_step", lambda: cfgs["image"][0]),
                (jconfigs, "get_config", lambda name: cfgs["coco"][1]),
                (tconfigs, "get_config", lambda name: cfgs["coco"][0])):
            mp.setattr(module, attr, value)
        with ThreadPoolExecutor(len(runs)) as pool:
            futures = {tag: pool.submit(run_jax, runs[tag][0], argv_of(tag, "jax"))
                       for tag in runs}
            port = {tag: run_port(runs[tag][0], argv_of(tag, "port")) for tag in runs}
            jax_out = {tag: f.result() for tag, f in futures.items()}
    assert len(made) == 1
    return dict(root=root, kitti=kitti, semkitti=semkitti, ckpt=ckpts["kitti"],
                base=[*step, *SIZE], jax=jax_out, port=port, jax_tta=made[0],
                model=tg.tiny_model("cpu"),
                out={tag: {pkg: os.path.join(root, f"{pkg}_{tag}") for pkg in ("jax", "port")}
                     for tag in runs})


def _port_test_step(argv, device=("--device", "cpu")) -> str:
    """The port's `test_step` under the trained tiny config."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "kitti_step_video_config", tg.tiny_cfg)
        return run_port("test_step", argv, device)


@pytest.mark.parametrize("tag", ["step", "step_tta"])
def test_test_step_matches_jax(serving, tag):
    """`_cat`, `_ins` and `final` of all 7 frames (two sequences) equal
    JAX's, plain at 64x128 (keep-ratio content 64x96 cropped back) and with
    multi-scale + flip TTA at 64x96; the printed lines equal."""
    out = serving["out"][tag]
    got = assert_same_pngs(out["port"], out["jax"], expect=3 * 7)
    assert masked(serving["port"][tag]) == masked(serving["jax"][tag]) == (
        "done: 7 frames in <t>s -> <out>\n")
    ins = [v for k, v in got.items() if k.endswith("_ins.png")]
    assert all(v.dtype == np.uint16 and v.shape == tg.HW for v in ins)
    assert len(np.unique(np.concatenate([v.ravel() for v in ins]))) >= 3  # tracks exist


@pytest.mark.parametrize("frame", [0, 5, 9])
def test_tta_fused_map_matches_jax(serving, frame):
    """`make_tta_semantic_fn` on the trained tiny model at 64x96, scales 0.75
    / 1.0 / 1.25 with flip, against the function JAX's CLI made: a golden
    frame (as `test_step` passes it) and a ragged crop of it, whose
    keep-ratio canvases pad, fuse to equal maps bit for bit."""
    from video_knet_tpu_torch.data.tta import make_tta_semantic_fn

    tfn = make_tta_semantic_fn(serving["model"], tg.tiny_cfg(), tg.HW, (0.75, 1.0, 1.25),
                               flip=True, device="cpu")
    rgb = tg.sequence_images()[frame]
    for img in (rgb, np.ascontiguousarray(rgb[5:, 3:])):
        got, want = tfn(img), serving["jax_tta"](img)
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape == tg.HW
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_tta_changes_only_the_semantic_maps(serving, tmp_path):
    """The TTA run's `_ins` maps equal a plain run's at the same size; some
    `_cat` maps differ."""
    _port_test_step(["--data-root", serving["kitti"], "--backbone", "mit_b0", "--size", "64",
                     "96", "--out", str(tmp_path), "--checkpoint", serving["ckpt"]["port"]])
    plain, tta = pngs(str(tmp_path)), pngs(serving["out"]["step_tta"]["port"])
    assert sorted(plain) == sorted(tta)
    for k in plain:
        if k.endswith("_ins.png"):
            np.testing.assert_array_equal(plain[k], tta[k])
    assert any(not np.array_equal(plain[k], tta[k]) for k in plain if k.endswith("_cat.png"))


def _torchvision_resnet18(path: str) -> dict:
    """A seeded ResNet-18 under torchvision's key names (layer4 and fc
    included), saved to `path`; returns its tensors by port key."""
    from video_knet_tpu_torch.models.video.appearance import AppearanceResNet, init_appearance

    enc = init_appearance(AppearanceResNet(18, remove_layers=()),
                          torch.Generator().manual_seed(3))
    sd = {}
    for k, v in enc.state_dict().items():
        k = re.sub(r"layer(\d)_block(\d+)\.", r"layer\1.\2.", k)
        sd[k.replace("downsample_conv.", "downsample.0.").replace("downsample_bn.",
                                                                  "downsample.1.")] = v
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 512), torch.zeros(10)
    torch.save({"state_dict": sd}, path)
    return enc.state_dict()


@pytest.mark.parametrize("tracker", TRACKERS)
def test_test_step_tracker_matches_the_pipeline(serving, tracker, tmp_path):
    """Each `--tracker` (unitrack with a torchvision ResNet-18 checkpoint as
    its appearance encoder): the CLI's `_ins` and `_cat` maps equal
    `run_frame` of the same pipeline frame by frame (the CLI drives the
    windowed `run_sequence` across the sequence boundary)."""
    from video_knet_tpu_torch.models.video.appearance import make_appearance_fn
    from video_knet_tpu_torch.tools.test_step import load_appearance

    extra, appearance_fn = [], None
    if tracker == "unitrack":
        pth = str(tmp_path / "r18.pth")
        src = _torchvision_resnet18(pth)
        extra = ["--appearance", "resnet18", "--appearance-checkpoint", pth]
        enc = load_appearance("resnet18", pth, torch.device("cpu"))
        for k, v in enc.state_dict().items():  # layer4 is removed
            assert torch.equal(v, src[k]), k
        appearance_fn = make_appearance_fn(enc)
    out = str(tmp_path / "out")
    _port_test_step([*serving["base"], "--tracker", tracker, *extra, "--out", out,
                     "--checkpoint", serving["ckpt"]["port"]])
    pipe = VPSInferencePipeline(serving["model"], tg.tiny_cfg(), (64, 128),
                                tracker_type=tracker, device="cpu", appearance_fn=appearance_fn)
    ds = KittiStepDVPS(serving["kitti"], split="val")
    n_tracks = set()
    for sample, first in ds.iter_test():
        x, (ch, cw) = keep_ratio_resize_pad(load_png(sample.img), (64, 128))
        res = pipe.run_frame(torch.from_numpy(x)[None], is_first=first)
        stem = os.path.join(out, "panoptic", str(sample.seq_id), f"{sample.img_id:06d}")
        np.testing.assert_array_equal(load_png(stem + "_ins.png"),
                                      (res.track_map[:ch, :cw] % 65536).astype(np.uint16))
        np.testing.assert_array_equal(load_png(stem + "_cat.png"),
                                      res.semantic_map[:ch, :cw].astype(np.uint8))
        n_tracks |= set(np.unique(res.track_map).tolist())
    assert len(n_tracks) >= 2, n_tracks


def test_cli_without_device_raises_on_a_box_without_a_gpu(serving, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port_test_step([*serving["base"], "--out", str(tmp_path)], device=())
    assert not os.listdir(tmp_path)


def test_test_vss_matches_jax(serving):
    """mIoU / aAcc and mVC over the same tree and weights: equal lines."""
    got = serving["port"]["vss"]
    assert got == serving["jax"]["vss"]
    assert got.startswith("mIoU ") and "mVC2 " in got and "mVC4 " in got and "mVC8" not in got


def test_test_dvps_matches_jax(serving):
    """SemKITTI-DVPS (random weights, score gates at zero), `--max-frames 3`:
    panoptic and GT-passthrough depth PNGs equal."""
    out = serving["out"]["dvps"]
    found = assert_same_pngs(out["port"], out["jax"], expect=3 * 3)
    assert masked(serving["port"]["dvps"]) == masked(serving["jax"]["dvps"]) == (
        "done: 3 frames in <t>s -> <out>\n")
    depth = found[os.path.join("depth", "0", "000000.png")]
    gt = load_png(os.path.join(serving["semkitti"], "video_sequence", "val",
                               "000000_000000_depth.png"))
    assert depth.dtype == np.uint16
    np.testing.assert_array_equal(depth, gt)  # 5-50 m: within the 80 m clip
    assert len(np.unique(found[os.path.join("panoptic", "0", "000000_ins.png")])) >= 2


def test_test_image_matches_jax(serving):
    """The Cityscapes-STEP image K-Net factory (patched to the tiny image
    config, random weights) over the KITTI-STEP tree, `--max-images 5`: the
    per-class table and the JSON line equal."""
    got = serving["port"]["image"]
    assert got == serving["jax"]["image"]
    lines = got.splitlines()
    assert len(lines) == 22 and lines[-2].startswith("ALL")
    res = json.loads(lines[-1])
    assert res["images"] == 5 and res["PQ"] > 0


def test_test_coco_instance_matches_jax(serving):
    """COCO instance results of three images (one listed at another size):
    the JSON equal entry for entry (ids, RLEs and boxes exactly, scores
    within 1e-5)."""
    want_line, got_line = (json.loads(serving[p]["coco"]) for p in ("jax", "port"))
    assert got_line["n_detections"] == want_line["n_detections"] > 0
    assert got_line["n_images"] == want_line["n_images"] == 3
    with open(got_line["results"]) as f, open(want_line["results"]) as g:
        got_res, want_res = json.load(f), json.load(g)
    assert len(got_res) == len(want_res)
    for a, b in zip(got_res, want_res):
        assert set(a) == set(b)
        assert (a["image_id"], a["category_id"], a["segmentation"], a["bbox"]) == (
            b["image_id"], b["category_id"], b["segmentation"], b["bbox"])
        # the scores are sigmoids of fp32 logits summed in another order
        assert a["score"] == pytest.approx(b["score"], rel=1e-5, abs=1e-6)
    assert {r["category_id"] for r in got_res} <= set(COCO_CATS)
    sizes = {r["image_id"]: tuple(r["segmentation"]["size"]) for r in got_res}
    assert sizes.get(11, (35, 40)) == (35, 40)


def test_checkpoint_flag_reads_a_model_state_and_checks_it(tmp_path):
    """`--checkpoint` reads `save_checkpoint`'s file of a model state (its
    directory or the file itself), merged over the seeded init; a key the
    model lacks or a shape it does not have raises."""
    from video_knet_tpu_torch.tools import _cli
    from video_knet_tpu_torch.utils.checkpoint import CHECKPOINT_FILE, load_model_state

    cfg = _tiny_image_cfg(tconfig.KNetConfig())
    src = KNet(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    path = save_checkpoint(str(tmp_path / "ck"), src, step=3)
    assert path.endswith("step_3")
    for p in (path, os.path.join(path, CHECKPOINT_FILE)):
        model = _cli.build_model(KNet, cfg, torch.device("cpu"), p)
        got, want = model.state_dict(), src.state_dict()
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    fresh = _cli.build_model(KNet, cfg, torch.device("cpu"))
    assert not torch.equal(fresh.rpn_head.init_kernels, src.rpn_head.init_kernels)
    sd = load_model_state(path)
    for bad, err in (({**sd, "extra.weight": torch.zeros(1)}, RuntimeError),
                     ({**sd, "rpn_head.init_kernels": torch.zeros(3, 3)}, ValueError)):
        torch.save({"model": bad}, str(tmp_path / "bad.pt"))
        with pytest.raises(err):
            _cli.build_model(KNet, cfg, torch.device("cpu"), str(tmp_path / "bad.pt"))


# ------------------------------------------------------------------ eval CLIs


def _gt_maps(rng, hw, n_frames, num_classes, thing_ids, void=255):
    """Seeded GT (semantic, instance) sequences: stuff bands, things with
    persistent ids moving, a void patch."""
    h, w = hw
    stuff = [c for c in range(num_classes) if c not in thing_ids]
    bands = rng.choice(stuff, 3, replace=False)
    boxes = [(rng.randint(0, h - 10), rng.randint(0, w - 16), thing_ids[k % len(thing_ids)], k + 1)
             for k in range(4)]
    out = []
    for f in range(n_frames):
        sem = np.full(hw, bands[0], np.int32)
        sem[h // 3:] = bands[1]
        sem[2 * h // 3:] = bands[2]
        sem[:3, :5] = void
        inst = np.zeros(hw, np.int32)
        for y, x, cls, k in boxes:
            x = min(w - 12, x + 2 * f)
            sem[y:y + 10, x:x + 12] = cls
            inst[y:y + 10, x:x + 12] = k
        out.append((sem, inst))
    return out


def _predictions(rng, gts, num_classes):
    """Each GT frame with noise in its classes and one id switch."""
    preds = []
    for sem, inst in gts:
        s = np.where(sem == 255, 0, sem)
        s = np.where(rng.rand(*s.shape) < 0.05, rng.randint(0, num_classes, s.shape), s)
        i = np.where(inst > 0, inst + (rng.rand() < 0.3), 0)
        preds.append((s.astype(np.uint8), i.astype(np.uint16)))
    return preds


def _write_eval_trees(root, mode, n_seqs=2, n_frames=4, hw=(24, 40), seed=0, depth=False):
    """Predictions under `{root}/res/panoptic/{seq}` (and `depth/{seq}`), GT
    under `{root}/gt` in `mode`'s encoding: the flat `{seq:06d}_{frame:06d}`
    layout, or per-video subdirectories for `vipseg`."""
    rng = np.random.RandomState(seed)
    vip = mode == "vipseg"
    num_classes, thing_ids = (124, list(range(58))) if vip else (19, [11, 13])
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir)
    for s in range(n_seqs):
        gts = _gt_maps(rng, hw, n_frames, num_classes, thing_ids[:2] if not vip else [0, 5])
        pdir = os.path.join(root, "res", "panoptic", str(s))
        os.makedirs(pdir)
        for f, ((sem, ins), (ps, pi)) in enumerate(zip(gts, _predictions(rng, gts, num_classes))):
            save_png(os.path.join(pdir, f"{f:06d}_cat.png"), ps)
            save_png(os.path.join(pdir, f"{f:06d}_ins.png"), pi)
            stem = os.path.join(gt_dir, f"{s:06d}_{f:06d}_")
            if mode == "kitti_rgb":
                rgb = np.stack([sem, ins // 256, ins % 256], -1).astype(np.uint8)
                save_png(stem + "panoptic.png", rgb)
            elif mode == "divisor":
                save_png(stem + "panoptic.png",
                         np.where(sem == 255, 0, sem * 1000 + ins).astype(np.uint16))
            elif mode == "class_instance":
                save_png(stem + "gtFine_class.png", sem.astype(np.uint8))
                save_png(stem + "gtFine_instance.png", ins.astype(np.uint16))
            else:  # raw VIP-Seg panomask: (raw id + 1) * 100 + inst, bare stuff ids + 1
                from video_knet_tpu_torch.data.panoptic_png import (
                    VIPSEG_STUFF_IDS,
                    VIPSEG_THING_IDS,
                )
                raw = np.zeros(sem.shape, np.int64)
                for c in np.unique(sem):
                    m = sem == c
                    if c == 255:
                        continue
                    if c < 58:
                        raw[m] = (VIPSEG_THING_IDS[c] + 1) * 100 + ins[m]
                    else:
                        raw[m] = VIPSEG_STUFF_IDS[c - 58] + 1
                vdir = os.path.join(gt_dir, f"video{s:03d}")
                os.makedirs(vdir, exist_ok=True)
                save_png(os.path.join(vdir, f"{f:06d}.png"), raw.astype(np.uint16))
                save_png(stem + "panoptic.png", raw.astype(np.uint16))
            if depth:
                d = (rng.uniform(2, 90, hw) * 256).astype(np.uint16)
                save_png(stem + "depth.png", d)
                if f < n_frames - 1:  # the last frame has no predicted depth
                    ddir = os.path.join(root, "res", "depth", str(s))
                    os.makedirs(ddir, exist_ok=True)
                    noisy = d * rng.uniform(0.85, 1.15, hw)
                    save_png(os.path.join(ddir, f"{f:06d}.png"),
                             np.clip(noisy, 0, 65535).astype(np.uint16))
    if vip:  # eval_dvpq reads the per-video layout; eval_stq the flat one
        return os.path.join(root, "res"), gt_dir, ["--num-classes", "124", "--thing-ids",
                                                   *map(str, range(58))]
    return os.path.join(root, "res"), gt_dir, []


MODES = ("kitti_rgb", "vipseg", "divisor", "class_instance")


def _eval_both(name, argv):
    want = run_jax(name, argv)
    got = run_port(name, argv, device=())
    assert got == want
    return got


@pytest.mark.parametrize("mode", MODES)
def test_eval_dvpq_matches_jax(tmp_path, mode):
    res, gt, extra = _write_eval_trees(str(tmp_path), mode)
    if mode == "vipseg":
        for f in os.listdir(gt):
            if f.endswith(".png"):
                os.remove(os.path.join(gt, f))
    out = _eval_both("eval_dvpq", [res, "--gt-dir", gt, "--ann-mode", mode,
                                   "--eval-frames", "1", "2", "4", *extra])
    assert [ln.split(":")[0] for ln in out.splitlines()] == ["k=1", "k=2", "k=4"]
    if mode != "class_instance":  # its GT is not in the panoptic file names
        assert float(out.split("PQ ")[1].split()[0]) > 0


@pytest.mark.parametrize("mode", MODES)
def test_eval_stq_matches_jax(tmp_path, mode):
    res, gt, extra = _write_eval_trees(str(tmp_path), mode)
    out = _eval_both("eval_stq", [res, "--gt-dir", gt, "--ann-mode", mode, *extra])
    assert out.startswith("STQ ") and float(out.split()[1]) > 0


@pytest.mark.parametrize("mode", ["class_instance", "kitti_rgb"])
def test_eval_dstq_matches_jax(tmp_path, mode):
    res, gt, extra = _write_eval_trees(str(tmp_path), mode, depth=True)
    out = _eval_both("eval_dstq", [res, "--gt-dir", gt, "--ann-mode", mode,
                                   "--depth-thresholds", "1.25", "1.1", "1.05", *extra])
    assert "DQ@1.25 " in out and "DQ@1.05 " in out and "DSTQ " in out


@pytest.mark.parametrize("two_channel", [True, False])
def test_eval_vpq_cityscapes_matches_jax(tmp_path, two_channel):
    """Cityscapes-VPS GT as 2-channel (category, instance) RGB PNGs, or as a
    single-channel id map; lambdas whose windows exceed a clip add nothing."""
    rng = np.random.RandomState(1)
    res = tmp_path / "res"
    gt = tmp_path / "gt"
    gt.mkdir()
    for s in ("0", "1"):
        gts = _gt_maps(rng, (24, 40), 6, 19, [11, 13], void=0)
        pdir = res / "panoptic" / s
        pdir.mkdir(parents=True)
        for f, ((sem, ins), (ps, pi)) in enumerate(zip(gts, _predictions(rng, gts, 19))):
            save_png(str(pdir / f"{f:06d}_cat.png"), ps)
            save_png(str(pdir / f"{f:06d}_ins.png"), pi)
            if two_channel:
                g = np.stack([sem, ins, np.zeros_like(sem)], -1).astype(np.uint8)
            else:  # category 0 (road) alone fits a 16-bit id map
                g = np.where(sem == 0, ins, 0).astype(np.uint16)
            save_png(str(gt / f"{s}_{f:06d}_gtFine_panoptic.png"), g)
    out = _eval_both("eval_vpq_cityscapes", [str(res), "--gt-dir", str(gt),
                                             "--lambdas", "0", "5", "10", "25"])
    assert [ln.split(":")[0] for ln in out.splitlines()] == [
        "lambda=0", "lambda=5", "lambda=10", "lambda=25"]
