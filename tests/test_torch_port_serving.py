"""The port's serving slice as a whole, on the CPU.

With weights converted from the JAX init of `tests/test_serving_golden.py`,
`video_knet_tpu_torch`'s VPSInferencePipeline, with the tracker on the
device (`quasi_dense`) and on the host (`quasi_dense_host`), reproduces
`tests/golden/serving_r50_64x96.npz` for all 4 frames:
id maps, semantic maps, track maps and segments_info bit-equal, segment
scores within 1e-4 (the golden's own tolerance). Also: the test step's
floats against JAX (1e-4 relative: R-50 + FPN + heads in fp32, summed in
another order), the config copy, the converter's strictness, the device
rule of the entry points, the options this slice does not port, and that
the port imports neither jax nor anything of video_knet_tpu.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, t

from video_knet_tpu import config as jc
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch.models.video.inference import (
    MultiStreamVPSPipeline,
    VPSInferencePipeline,
)
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.utils.convert import flatten_variables, load_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "serving_r50_64x96.npz")
N_FRAMES = 4
HW = (64, 96)


def _golden_cfg(cfg_mod):
    """The config of tests/test_serving_golden.py:_setup (score gates at zero)."""
    base = cfg_mod.VideoKNetConfig(max_insts=8)
    return dataclasses.replace(
        base,
        test=dataclasses.replace(base.test, instance_score_thr=0.0),
        tracker=dataclasses.replace(base.tracker, init_score_thr=0.0, obj_score_thr=0.0,
                                    match_score_thr=0.05),
    )


@pytest.fixture(scope="module")
def golden_setup():
    jcfg = _golden_cfg(jc)
    jm = JVideoKNet(jcfg, train=False)
    img = jnp.zeros((1, *HW, 3), jnp.float32)
    # jit(init) gives the same values as the golden's eager init, sooner
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), img, img)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(0)
    frames = [rng.randn(1, *HW, 3).astype(np.float32) for _ in range(N_FRAMES)]
    cfg = _golden_cfg(tc)
    model = load_flax_variables(VideoKNet(cfg, device="cpu"), variables)
    return dict(jcfg=jcfg, jm=jm, variables=variables, frames=frames, cfg=cfg, model=model)


def _run(setup, tracker_type="quasi_dense"):
    pipe = VPSInferencePipeline(setup["model"], setup["cfg"], HW, tracker_type=tracker_type,
                                device="cpu")
    return [pipe.run_frame(f, is_first=(i == 0)) for i, f in enumerate(setup["frames"])]


def _flatten(results) -> dict:
    """The golden surface (tests/test_serving_golden.py:_flatten)."""
    arrs = {}
    for i, r in enumerate(results):
        arrs[f"pan_{i}"] = np.asarray(r.panoptic_seg, np.int32)
        arrs[f"sem_{i}"] = np.asarray(r.semantic_map, np.int32)
        arrs[f"trk_{i}"] = np.asarray(r.track_map, np.int64)
        segs = sorted(r.segments_info, key=lambda s: s["id"])
        arrs[f"seg_ids_{i}"] = np.array([s["id"] for s in segs], np.int64)
        arrs[f"seg_cat_{i}"] = np.array([s["category_id"] for s in segs], np.int64)
        arrs[f"seg_isthing_{i}"] = np.array([bool(s["isthing"]) for s in segs], bool)
        arrs[f"seg_score_{i}"] = np.array([float(s.get("score", 0.0)) for s in segs],
                                          np.float32)
    return arrs


def _assert_matches_golden(arrs):
    gold = np.load(GOLDEN)
    assert set(gold.files) == set(arrs)
    for k in gold.files:
        if k.startswith("seg_score_"):
            np.testing.assert_allclose(arrs[k], gold[k], atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(arrs[k], gold[k], err_msg=k)
    assert any((arrs[f"trk_{i}"] > 0).any() for i in range(N_FRAMES))


def test_port_serving_matches_golden(golden_setup):
    _assert_matches_golden(_flatten(_run(golden_setup)))


def test_port_host_tracker_serving_matches_golden(golden_setup):
    _assert_matches_golden(_flatten(_run(golden_setup, "quasi_dense_host")))


def test_port_serving_is_deterministic(golden_setup):
    first, second = _flatten(_run(golden_setup)), _flatten(_run(golden_setup))
    for k in first:
        np.testing.assert_array_equal(first[k], second[k], err_msg=k)


def test_port_test_step_matches_jax(golden_setup):
    s = golden_setup
    jm, cfg = s["jm"], s["cfg"]
    img = s["frames"][1]
    prev = np.random.RandomState(1).randn(1, 117, 1, 256).astype(np.float32)
    step = jax.jit(lambda v, i, p: jm.apply(v, i, p, False, method=JVideoKNet.test_step))
    want = step(s["variables"], img, prev)
    with torch.no_grad():
        got = s["model"].test_step(t(img), t(prev), False)
    for key in ("track_obj_feats", "track_embeds", "new_obj_feats"):
        assert_rel_close(got[key], want[key], 1e-4, key)
    for i, (a, b) in enumerate(zip(got["stage_outs"], want["stage_outs"])):
        assert_rel_close(a.cls_score, b.cls_score, 1e-4, f"stage {i} cls")
        assert_rel_close(a.scaled_mask_preds, b.scaled_mask_preds, 1e-4, f"stage {i} masks")
    assert_rel_close(got["rpn_out"].seg_preds, want["rpn_out"].seg_preds, 1e-4, "seg_preds")
    assert cfg.num_proposals + cfg.num_stuff_classes == 117


@pytest.mark.parametrize("name", ["VideoKNetConfig", "KNetConfig", "TrackerConfig",
                                  "TestCfg", "KernelUpdateHeadConfig", "ConvKernelHeadConfig"])
def test_config_copy_matches_jax(name):
    assert dataclasses.asdict(getattr(tc, name)()) == dataclasses.asdict(getattr(jc, name)())


def test_converter_is_strict(golden_setup):
    flat = flatten_variables(golden_setup["variables"])
    model = golden_setup["model"]
    # the flat params/... layout of tests/trained_golden_common.py loads too
    load_flax_variables(model, flat)
    missing = dict(flat)
    missing.pop("params/track_embed/fc_embed/bias")
    with pytest.raises(KeyError):
        load_flax_variables(model, missing)
    extra = dict(flat, **{"params/track_embed/extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        load_flax_variables(model, extra)
    wrong = dict(flat, **{"params/rpn_head/init_kernels": np.zeros((99, 256), np.float32)})
    with pytest.raises(ValueError):
        load_flax_variables(model, wrong)
    load_flax_variables(model, golden_setup["variables"])  # leave the fixture intact


def test_entry_points_default_to_cuda():
    from video_knet_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        VideoKNet(tc.VideoKNetConfig())
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("change", [
    dict(backbone="swin_b_rfp"),
    dict(head=tc.KernelUpdateHeadConfig(mask_upsample_stride=4, conv_kernel_size=3)),
    dict(backbone="detectors_r50"), dict(backbone="resnet18"),
])
def test_unported_model_options_raise(change):
    """Once unported, now as JAX's: the RFP backbones build (no neck); K=3
    builds and its forward fails at the first stage's mask assembly, as
    JAX's does (tests/test_torch_port_sfnet.py); an unknown backbone
    raises."""
    cfg = dataclasses.replace(tc.VideoKNetConfig(), **change)
    if cfg.backbone == "resnet18":
        with pytest.raises(ValueError, match="unknown backbone"):
            VideoKNet(cfg, device="cpu")
        return
    model = VideoKNet(cfg, device="cpu")
    if cfg.head.conv_kernel_size == 3:
        with pytest.raises(ValueError, match="cannot reshape kernels"), torch.no_grad():
            model.run_branch(torch.zeros(1, 64, 96, 3))
    else:
        assert model.neck is None
        assert model.rpn_head.localization_fpn.l0_conv0.Conv_0.weight.shape[1] == 256


def test_unported_serving_options_raise(golden_setup):
    """An unknown tracker_type raises ValueError, as the reference's
    `_make_tracker` does (every tracker of the reference is ported)."""
    cfg, model = golden_setup["cfg"], golden_setup["model"]
    with pytest.raises(ValueError, match="tracker_type"):
        VPSInferencePipeline(model, cfg, HW, tracker_type="deep_sort", device="cpu")
    with pytest.raises(ValueError, match="tracker_type"):
        MultiStreamVPSPipeline(model, cfg, HW, 2, tracker_type="bytetrack", device="cpu")
    # the aligned SFNet head, once unported here, builds
    # (tests/test_torch_port_sfnet.py holds it to JAX)
    aligned = VideoKNet(dataclasses.replace(cfg, rpn=dataclasses.replace(
        cfg.rpn, fpn_type="upernet_align")), device="cpu")
    assert type(aligned.rpn_head.localization_fpn).__name__ == "UperNetAlignHead"


# the modules of the later slices (training, Swin, VIS, image, the trackers
# and track heads, scoring, data, TTA and the CLIs, the VIS / COCO data and
# the VIS CLIs, the train CLIs and their utilities, data parallelism, the
# last model modules), which the guard must find and import
TRAIN_SLICE_MODULES = ("ops.losses", "ops.targets", "ops.hungarian", "ops.kernels.hungarian",
                       "train.optim", "train.train_state", "train.vps", "train.demo_train",
                       "tools.train_check", "models.swin", "configs", "utils.torch_import",
                       "config_vis", "models.vis.clip_head", "models.vis.volume_head",
                       "models.vis.knet_vis", "train.vis", "ops.sampling",
                       "models.msdeform_decoder", "train.image",
                       "models.video.roi_track_head", "models.video.tracker_variants",
                       "models.video.tao_tracker", "models.video.unitrack",
                       "models.video.appearance", "models.video.hrnet", "eval",
                       "eval.vpq", "eval.stq", "eval.miou", "eval.coco_instance", "data",
                       "data.rle", "utils.checkpoint", "tools.reference_sd", "tools.eval_check",
                       "data.panoptic_png", "data.transforms", "data.datasets", "data.loader",
                       "native.png_codec", "native.build", "train.eval_hook", "data.tta",
                       "tools._cli", "tools.test_step", "tools.test_vss", "tools.test_dvps",
                       "tools.test_image", "tools.test_coco_instance", "tools.eval_dvpq",
                       "tools.eval_stq", "tools.eval_dstq", "tools.eval_vpq_cityscapes",
                       "data.polygon", "data.ytvis", "data.vis_loader", "data.coco_panoptic",
                       "data.forecasting", "tools.youtubevis2coco", "tools.test_whole_video",
                       "tools.data_check", "tools.train_vps", "tools.train_vis",
                       "tools.train_image", "tools.get_flops", "utils.preemption",
                       "utils.profiling", "utils.visualizer", "utils.precision", "parallel",
                       "parallel.mesh", "parallel.distributed", "tools.dp_check",
                       "models.rfp", "models.sfnet", "models.deform_conv",
                       "tools.profile_train", "tools.kitti_step_prepare")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import video_knet_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'video_knet_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'video_knet_tpu')]\n"
        "need = {'video_knet_tpu_torch.' + m for m in TRAIN_SLICE}\n"
        "missing = need - set(mods)\n"
        "assert len(mods) >= 40 and not missing and not bad, (len(mods), missing, bad)\n"
        # the card has no PIL: nothing of the port imports it when imported
        "assert 'PIL' not in sys.modules, [m for m in sys.modules if m.startswith('PIL')]\n"
    ).replace("TRAIN_SLICE", repr(TRAIN_SLICE_MODULES))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|video_knet_tpu)\b(?!_torch)",
                     re.M)
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "video_knet_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    offenders = [s for s in sources if pat.search(open(s).read())]
    assert not offenders, offenders
