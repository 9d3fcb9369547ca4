"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both the JAX function
and its port; weights go from the flax variables to the port through
`video_knet_tpu_torch.utils.convert`.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import io
import json
import os
import pickle
import re
import subprocess
import sys
import types
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import video_knet_tpu.ops.hungarian as jhung
from video_knet_tpu.models import msdeform_decoder as jdec
from video_knet_tpu.models.knet import branch_assignment_costs
from video_knet_tpu.models.swin import SwinTransformer as JSwin
from video_knet_tpu.utils import checkpoint as jck
from video_knet_tpu_torch.tools.data_check import write_ytvis_cocovid
from video_knet_tpu_torch.models.backbones import backbone_and_neck, build_backbone
from video_knet_tpu_torch.models.layers import init_parameters
from video_knet_tpu_torch.tools.train_check import (
    NECK_LAYERS,
    draw_zero_init_leaves,
    image_check_cfg,
    relu_pattern,
)
from video_knet_tpu_torch.utils.checkpoint import save_checkpoint
from video_knet_tpu_torch.utils.convert import load_flax_variables, state_dict_to_flax

# One intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and torch's default (one thread a core in every worker)
# oversubscribes the cores many times over. Every port test file imports
# this module or makes the same call.
torch.set_num_threads(1)


def t(x) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (copy)."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def perturb_norms(variables, seed: int = 0):
    """Move norm scales/biases and BN statistics off their init values
    (1, 0, 0, 1), so the parity tests also check how they are carried."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k, v in flat.items():
        leaf = k[-1]
        if leaf in ("scale", "var"):
            v = (1.0 + 0.2 * np.abs(rng.randn(*v.shape))).astype(v.dtype)
        elif leaf in ("bias", "mean"):
            v = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
        out[k] = v
    return traverse_util.unflatten_dict(out)


def perturbed_variables(module: torch.nn.Module, seed: int):
    """The port module's weights as a flax tree, norms and statistics
    perturbed off their init values (`perturb_norms`)."""
    tree = traverse_util.unflatten_dict(state_dict_to_flax(module, module.state_dict()), sep="/")
    return perturb_norms(tree, seed=seed)


def weight_of(leaf: str) -> str:
    """The flax leaf whose largest magnitude scales `leaf`'s gradient
    tolerance: its own, but an attention key's bias takes its kernel's (the
    bias's true gradient is zero: softmax over the keys ignores a shift that
    is equal for every key, so both packages hold rounding noise there)."""
    if leaf.endswith("/key/bias"):
        return leaf[:-len("bias")] + "kernel"
    return leaf


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-12)


def port_of(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax variables into a port module (strict) and set eval mode."""
    return load_flax_variables(module, variables).eval()


def flax_tree(flat: dict) -> dict:
    """{"a/b/c": leaf} -> the nested variables tree."""
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def jax_tree_shapes(jmod, *args) -> dict:
    """{"collection/path/leaf": shape} of `jax.eval_shape` of JAX's init."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    return {"/".join(k): tuple(v.shape)
            for k, v in traverse_util.flatten_dict(flax.core.unfreeze(shapes)).items()}


def shared_weights(module: torch.nn.Module, jmod, *args, seed: int = 0):
    """The port's seeded init of `module`, with the leaves the reference
    initializes at zero drawn nonzero (`train_check.draw_zero_init_leaves`)
    and the norms perturbed (`perturb_norms`), loaded into `module` and
    returned as flax variables; their tree is held against JAX's init's
    (`jax_tree_shapes` of `jmod` on `args`)."""
    g = torch.Generator().manual_seed(seed)
    init_parameters(module, g)
    draw_zero_init_leaves(module, g)
    flat = state_dict_to_flax(module, module.state_dict())
    assert {k: v.shape for k, v in flat.items()} == jax_tree_shapes(jmod, *args)
    variables = perturb_norms(flax_tree(flat), seed)
    port_of(module, variables)
    return variables


def jit_apply(jmod, variables, *args, **kwargs):
    """JAX's forward, jitted: one compile costs less than op-by-op dispatch
    compiling each primitive."""
    return jax.jit(lambda v, *a: jmod.apply(v, *a, **kwargs))(variables, *args)


def seeded_inputs(seed: int, *shapes) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def assert_rel_close(got, want, rel: float, what: str = "") -> None:
    """max |got - want| <= rel * max |want| (fp32 sums in another order)."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} * {scale:.3e}"


def jax_step_costs(key, ref, gt, ref_gt, cfg):
    """JAX's cost matrices and assignments of a VPS train step, stacked as
    `video_knet_loss` stacks them (`knet_vps.py:374-405`): (costs, valids,
    g2p, p2g)."""
    n = cfg.num_proposals

    def track_cost(last, bgt):
        return jax.vmap(lambda m, c, gm, gl: jhung.hungarian_cost_matrix(
            m, gm, c, gl, cls_weight=cfg.assigner.cls_weight,
            dice_weight=cfg.assigner.dice_weight, mask_weight=cfg.assigner.mask_weight))(
            last.scaled_mask_preds[:, :n], last.cls_score[:, :n, :cfg.num_thing_classes],
            bgt.masks, bgt.labels)

    kc = branch_assignment_costs(key.rpn_out, key.stage_outs, gt, cfg)
    rc = branch_assignment_costs(ref.rpn_out, ref.stage_outs, ref_gt, cfg)
    costs = jnp.concatenate(kc + [track_cost(key.stage_outs[-1], gt)] + rc
                            + [track_cost(ref.stage_outs[-1], ref_gt)])
    valids = jnp.concatenate([gt.valid] * (len(kc) + 1) + [ref_gt.valid] * (len(kc) + 1))
    g2p, p2g = jax.vmap(jhung.pad_and_solve)(costs, valids)
    return costs, valids, g2p, p2g


# the input of every ReLU of the heads and necks, by its owner: a
# ConvNormAct's GroupNorm, an MLP layer's LayerNorm, a KernelUpdator's
# fc_norm, an FFN's Dense_0, a deformable encoder layer's ffn1, the RoI
# track head's GroupNorms and hidden fc, the query track head's fc0, the
# kernel track embedding's embed_ln0 and track fcs (the same names in both
# packages); and of ResNet's: the stem's and a bottleneck's bn1 / bn2, and a
# block's own output for its last ReLU (relu(z) > 0 exactly where z > 0)
def _pre_relu(owner: str, name: str) -> bool:
    return ((owner == "ResNet" and (name == "bn1"
                                    or re.fullmatch(r"layer\d+_block\d+", name) is not None))
            or (owner == "BottleneckBlock" and name in ("bn1", "bn2"))
            or (owner == "TrackEmbed" and (name == "embed_ln0"
                                           or re.fullmatch(r"track_fc\d+", name) is not None))
            or (owner == "ConvNormAct" and name == "GroupNorm_0")
            or (owner == "MLP" and name.startswith("LayerNorm_"))
            or (owner == "KernelUpdator" and name == "fc_norm")
            or (owner == "FFN" and name == "Dense_0")
            or (owner == "DeformAttnEncoderLayer" and name == "ffn1")
            or (owner == "ROITrackHead" and (name.startswith("gn")
                                             or re.fullmatch(r"fc\d+", name) is not None))
            or (owner == "QueryTrackEmbed" and name == "fc0"))


def jax_pre_relu(mdl, method: str) -> bool:
    """`capture_intermediates` filter of flax's `apply`: the ReLU inputs,
    whose signs are JAX's ReLU decisions."""
    owner = type(mdl.parent).__name__ if mdl.parent is not None else ""
    return method == "__call__" and _pre_relu(owner, mdl.name)


def relu_call_order(model: torch.nn.Module, run) -> list:
    """The names of the port's ReLU-input modules in the order `run()`
    calls them (forward hooks), a module called several times once a call."""
    order, hooks = [], []
    for name, m in model.named_modules():
        owner = type(model.get_submodule(name.rpartition(".")[0])).__name__ if name else ""
        if _pre_relu(owner, name.rpartition(".")[2]):
            hooks.append(m.register_forward_hook(lambda *_, name=name: order.append(name)))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return order


def jax_relu_decisions(intermediates, model: torch.nn.Module, run, order=None) -> list:
    """JAX's ReLU decisions, from the ReLU inputs captured with
    `jax_pre_relu`, in the order the port calls its ReLUs during `run()`
    (or `order`, `relu_call_order`'s), for
    `train_check.relu_pattern(..., replay=True)`; each replayed call checks
    its shape. A module called several times (the VPS stages on the ref and
    the key branch) takes JAX's calls in their order."""
    if order is None:
        order = relu_call_order(model, run)
    flat = traverse_util.flatten_dict(intermediates, sep="/")
    seen: dict[str, int] = {}
    out = []
    for name in order:
        i = seen[name] = seen.get(name, -1) + 1
        out.append(torch.from_numpy(np.asarray(flat[name.replace(".", "/") + "/__call__"][i]) > 0))
    return out


@functools.lru_cache(maxsize=None)
def jax_swin_tiny_apply(ape: bool = False):
    """JAX's Swin-tiny forward, jitted once a process for the files that
    share it (the port's Swin and its checkpoint import)."""
    return jax.jit(JSwin("tiny", ape=ape).apply)


class _ShallowDecoder(jdec.MSDeformAttnPixelDecoder):
    """JAX's MSDeformAttn decoder at the check models' encoder depth
    (`train_check.shallow_neck`)."""

    num_layers: int = NECK_LAYERS


def jax_shallow_neck():
    """While active, JAX's `build_neck` builds `_ShallowDecoder` (it imports
    the decoder class when called); trace the JAX function inside it."""
    return mock.patch.object(jdec, "MSDeformAttnPixelDecoder", _ShallowDecoder)


# ------------------------------------------------- the RFP backbones on bands

# DetectoRS in fp64: its random levels reach ~1e4 over the two RFP passes,
# and fp32 sums over a band and over the whole map round apart by ~1e-4 of
# a parameter's gradient where they cancel (a SAC switch's bias: a scalar
# summed over every pixel); the RFP Swin's levels are normed, fp32 holds
RFP_DTYPES = {"detectors_r50": torch.float64, "swin_tiny_rfp": torch.float32}


def seeded_rfp(name: str, seed: int = 0) -> torch.nn.Module:
    """A seeded RFP backbone in eval mode, in its case's dtype: the
    zero-initialized leaves drawn nonzero, DetectoRS's statistics off their
    init."""
    gen = torch.Generator().manual_seed(seed)
    backbone = build_backbone(name)
    init_parameters(backbone, gen)
    draw_zero_init_leaves(backbone, gen)
    with torch.no_grad():
        for key, buf in backbone.named_buffers():
            if key.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
            elif key.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=gen)
    return backbone.to(RFP_DTYPES[name]).eval()


def rfp_pyramid_case(backbone, name: str, n_model: int, hw) -> tuple[dict, dict]:
    """The band split's spec of RFP `backbone` (`name`, from `seeded_rfp`)
    over `n_model` ranks on a seeded image of `hw` (`dp_check.pyramid_share`),
    and the whole forward and backward here, whose ReLU decisions the bands
    replay: (spec, {"levels", "grad_img" (None for DetectoRS: its stem is
    cut from the graph), "grads"})."""
    rng = np.random.RandomState(n_model + hw[0])
    img = torch.from_numpy(rng.randn(1, *hw, 3)).to(RFP_DTYPES[name])
    x = img.clone().requires_grad_(True)
    relus: list = []
    with relu_pattern(relus):
        levels = backbone_and_neck(backbone, None, x)
    cot = [torch.from_numpy(rng.randn(*lv.shape)).to(lv.dtype) for lv in levels]
    sum((lv * c).sum() for lv, c in zip(levels, cot)).backward()
    grads = {f"backbone.{n}": p.grad.clone() for n, p in backbone.named_parameters()
             if p.grad is not None}
    backbone.zero_grad(set_to_none=True)
    whole = dict(levels=[lv.detach() for lv in levels], grad_img=x.grad, grads=grads)
    spec = dict(kind="pyramid", n_model=n_model, backbone=name, img=img, cotangents=cot,
                weights=(backbone.state_dict(), None), relus=relus or None)
    return spec, whole


def assert_rfp_bands(whole: dict, ranks: list, level_rel: float, grad_rel: float) -> None:
    """`rfp_pyramid_case`'s whole forward against its ranks' results: each
    rank's band of each level within `level_rel` of the level's largest
    magnitude, the bands covering the level; the parameters' gradients
    summed over the ranks within `grad_rel` of each one's largest
    magnitude; the image's absent on every side (DetectoRS) or, summed,
    within `grad_rel`; nothing gathered."""
    for i, want in enumerate(whole["levels"]):
        scale = float(want.abs().max())
        for r in ranks:  # each rank's band of the level, no gather of the pyramid
            a, b = r["rows"][i]
            assert float((r["levels"][i] - want[:, a:b]).abs().max()) <= level_rel * scale, i
        assert ranks[0]["rows"][i][0] == 0 and ranks[-1]["rows"][i][1] == want.shape[1]
    if whole["grad_img"] is None:
        assert all(r["grad_img"] is None for r in ranks)
    else:
        grad = sum(r["grad_img"] for r in ranks)
        assert rel_err(grad.numpy(), whole["grad_img"].numpy()) <= grad_rel
    assert set(whole["grads"]) == set().union(*(r["grads"] for r in ranks))
    for k, g in whole["grads"].items():
        got = sum(r["grads"][k] for r in ranks if k in r["grads"])
        assert float((got - g).abs().max()) <= grad_rel * float(g.abs().max()), k
    assert all(r["comm"]["gather"] == 0 and r["comm"]["halo"] > 0 for r in ranks)


# ------------------------------------------------- CLIs in process (both packages)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCO_CATS = (1, 3, 7, 9, 12)


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


def _ytvis_tree(root) -> tuple[str, str]:
    """A seeded YouTube-VIS val tree (two videos, 5 frames of 48x80 and 4),
    converted to COCO-VID by the port's `youtubevis2coco`: (json, image root)."""
    ann, img_root = write_ytvis_cocovid(root, n_videos=2, n_frames=5, hw=(48, 80), seed=3)
    with open(ann) as f:
        coco = json.load(f)
    last = max(im["id"] for im in coco["images"])  # the second video loses a frame
    coco["images"] = [im for im in coco["images"] if im["id"] != last]
    coco["annotations"] = [a for a in coco["annotations"] if a["image_id"] != last]
    with open(ann, "w") as f:
        json.dump(coco, f)
    return ann, img_root


# ------------------------------------------------- JAX jobs in processes of their own

JOBS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_jax_jobs.py")
JOB_TIMEOUT_S = 900


def no_positives(gt, row: int):
    """A port `PanopticGT` with image `row` empty: no thing, no stuff."""
    out = [x.clone() for x in gt]
    masks, labels, valid, ids, sem, sem_valid = out
    masks[row] = 0
    valid[row] = False
    ids[row] = -1
    sem[row] = 0
    sem_valid[row] = False
    return type(gt)(*out)


def _send_spec(tmp: str, tag: str, spec: dict) -> None:
    """The job `tag`'s spec, written whole at once (the job may be waiting
    for it)."""
    spec_path = os.path.join(tmp, f"{tag}.spec")
    with open(spec_path + ".tmp", "wb") as f:
        pickle.dump(spec, f)
    os.replace(spec_path + ".tmp", spec_path)


def _spawn(tmp: str, tag: str, spec: dict | None, nice: int = 10, devices: int = 1):
    """`tests/torch_port_jax_jobs.py` on `spec` in a process of its own,
    JAX on `devices` virtual CPU devices, at `nice` (the longest job goes
    first for the cores): (the process, its result file). With `spec`
    None the job imports and waits for `_send_spec`."""
    out = os.path.join(tmp, f"{tag}.out")
    spec_path = os.path.join(tmp, f"{tag}.spec")
    if spec is not None:
        _send_spec(tmp, tag, spec)
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    if devices > 1:
        flags.append(f"--xla_force_host_platform_device_count={devices}")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(flags))
    proc = subprocess.Popen([sys.executable, JOBS, spec_path, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    os.setpriority(os.PRIO_PROCESS, proc.pid, nice)
    return proc, out


def _collect(proc, out: str):
    """The job's result; its spec and result files removed (the R-50
    ones hold 100 MB each)."""
    log = proc.communicate(timeout=JOB_TIMEOUT_S)[0]
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        result = pickle.load(f)
    os.remove(out)
    os.remove(out[:-len(".out")] + ".spec")
    return result
