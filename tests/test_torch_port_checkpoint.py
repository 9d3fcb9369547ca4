"""The port's checkpoints and reference importers against the JAX package's,
on the CPU.

Importers (`utils/checkpoint.py`, `utils/torch_import.py`): the same seeded
reference-named state dict goes through JAX's importer and the port's;
the port's result is loaded strictly into the port's module and read back
in flax's layouts (`utils/convert.state_dict_to_flax`), which must equal
JAX's leaves bit for bit. The dicts: the image K-Net R-50 and the
joint-train Video K-Net of `tests/test_torch_import.py` (release widths),
ResNet-only (mmdet R-50 and torchvision-named ResNet-18/34/50 for the
UniTrack zoo), FPN-only, UniTrack's HRNet-w18 (`tests/test_hrnet.py`'s
torch transcription), and the Swin-backbone joint-train dict of
`test_import_joint_train_swin_backbone_dispatch`. Strict mode raises on a
leftover key in both packages; `image_to_video_params`, `merge_params` and
`load_torch_file` behave as JAX's. No JAX model is built: the importers
are pure name and layout maps.

Own checkpoints: 3 straight train steps against 2 steps, `save_checkpoint`,
`restore_checkpoint` into a model and optimizer built from another seed, and
1 more step: parameters, AdamW moments, step and learning rates bit-equal,
on the trained tiny config (no stochastic depth) and on the Swin check
config with drop path 0.3 drawn from a carried generator.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)
from test_hrnet import THRNet, _randomize_bn
from test_swin_import import build_official_swin_sd
from test_torch_import import add_joint_train_sd, build_reference_sd

from video_knet_tpu.utils import checkpoint as jck
from video_knet_tpu.utils import torch_import as jti
from video_knet_tpu_torch.config import KNetConfig, VideoKNetConfig
from video_knet_tpu_torch.models.knet import KNet
from video_knet_tpu_torch.models.resnet import FPN, ResNet
from video_knet_tpu_torch.models.video.appearance import AppearanceResNet
from video_knet_tpu_torch.models.video.hrnet import HRNetEncoder
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.tools import reference_sd as rsd
from video_knet_tpu_torch.tools import train_check
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.train.optim import make_optimizer
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step
from video_knet_tpu_torch.utils import checkpoint as tck
from video_knet_tpu_torch.utils.convert import flatten_variables, state_dict_to_flax
from video_knet_tpu_torch.utils.torch_import import import_torch_knet


def _reference_sd(joint: bool) -> dict:
    torch.manual_seed(0)  # those functions draw from torch's global generator
    sd = build_reference_sd()
    if joint:
        add_joint_train_sd(sd)
    return sd


def _video_tree(params: dict) -> dict:
    """JAX's image K-Net tree with the stages at the top, as the video
    model holds them (tests/test_torch_import.py)."""
    out = dict(params)
    out.update(out.pop("roi_head"))
    return out


def _assert_loaded_equals_jax(module, imported: dict, jax_params: dict,
                              jax_stats: dict) -> None:
    """`imported` loads strictly into `module`; its tensors, read back from
    the module in flax's layouts, equal JAX's leaves bit for bit."""
    module.load_state_dict(imported, strict=True)
    own = module.state_dict()
    got = state_dict_to_flax(module, {k: own[k] for k in imported})
    want = flatten_variables({"params": jax_params, "batch_stats": jax_stats})
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# ------------------------------------------------------------------ K-Net


def test_reference_sd_has_the_tests_key_set():
    """`tools/reference_sd.py` (JAX-free, for chip_smoke) builds the key
    set and shapes of `tests/test_torch_import.py`'s dicts."""
    gen = torch.Generator().manual_seed(0)
    for joint in (False, True):
        want = _reference_sd(joint)
        got = rsd.build_reference_sd(gen)
        if joint:
            rsd.add_joint_train_sd(got, gen)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("joint", [False, True], ids=["image", "joint_train"])
def test_import_knet_matches_jax(joint):
    sd = _reference_sd(joint)
    sd["backbone.bn1.num_batches_tracked"] = torch.tensor(100)  # a buffer to tolerate
    params, stats = jti.import_torch_knet(sd, strict=True)
    out = import_torch_knet(sd, strict=True)
    if joint:
        assert "roi_head.mask_head_2.attention_previous.query.weight" in out
        assert not any(k.startswith("roi_head.mask_head_0.attention_previous") for k in out)
        model = VideoKNet(VideoKNetConfig(), device="cpu")
        _assert_loaded_equals_jax(model, tck.image_to_video_params(out), _video_tree(params),
                                  stats)
    else:
        _assert_loaded_equals_jax(KNet(KNetConfig(), device="cpu"), out, params, stats)
    # the layout rules, against the source dict
    w = sd["roi_head.mask_head.1.attention.attn.in_proj_weight"]
    assert torch.equal(out["roi_head.mask_head_1.attention.key.weight"], w[256:512])
    assert torch.equal(out["rpn_head.init_kernels"],
                       sd["rpn_head.init_kernels.weight"][:, :, 0, 0])


def test_import_knet_swin_backbone_dispatch_matches_jax():
    """A joint-train dict with a Swin-tiny backbone (the Swin VIP-Seg /
    KITTI-STEP configs' form) goes to `import_torch_swin`; strict in both."""
    sd = _reference_sd(True)
    for k in [k for k in sd if k.startswith("backbone.")]:
        del sd[k]
    swin = build_official_swin_sd("tiny")
    for k in ("head.weight", "head.bias", "norm.weight", "norm.bias"):
        del swin[k]
    for i, dim in enumerate((96, 192, 384, 768)):
        swin[f"norm{i}.weight"] = torch.randn(dim) * 0.05
        swin[f"norm{i}.bias"] = torch.randn(dim) * 0.05
    sd.update({"backbone." + k: v for k, v in swin.items()})
    for i, cin in enumerate((96, 192, 384, 768)):
        sd[f"neck.lateral_convs.{i}.conv.weight"] = torch.randn(256, cin, 1, 1) * 0.05
    params, stats = jti.import_torch_knet(sd, strict=True)
    assert stats == {}
    out = import_torch_knet(sd, strict=True)
    model = VideoKNet(VideoKNetConfig(max_insts=4, backbone="swin_tiny"), device="cpu")
    _assert_loaded_equals_jax(model, tck.image_to_video_params(out), _video_tree(params), {})


def test_import_knet_reads_its_counts_off_the_dict():
    """A 2-stage image K-Net with 2 cls fcs and 2 loc convs: the port reads
    those counts off the keys, and equals JAX's importer told them."""
    sd = _reference_sd(False)
    for k in [k for k in sd if k.startswith("roi_head.mask_head.2.")]:
        del sd[k]
    gen = torch.Generator().manual_seed(1)
    for s in range(2):
        pre = f"roi_head.mask_head.{s}.cls_fcs"
        sd[f"{pre}.3.weight"] = torch.randn(256, 256, generator=gen) * 0.05
        sd[f"{pre}.4.weight"] = 1 + torch.randn(256, generator=gen) * 0.05
        sd[f"{pre}.4.bias"] = torch.randn(256, generator=gen) * 0.05
    for k in [k for k in sd if k.startswith("rpn_head.loc_convs.0.")]:
        sd[k.replace("loc_convs.0.", "loc_convs.1.")] = \
            sd[k] + torch.randn(sd[k].shape, generator=gen) * 0.05
    params, stats = jti.import_torch_knet(sd, num_stages=2, num_cls_fcs=2, num_loc_convs=2,
                                          strict=True)
    out = import_torch_knet(sd, strict=True)
    assert not any(k.startswith("roi_head.mask_head_2.") for k in out)
    cfg = KNetConfig(num_stages=2, assign_stages=2, stage_loss_weights=(1.0, 1.0),
                     rpn=dataclasses.replace(KNetConfig().rpn, num_loc_convs=2),
                     head=dataclasses.replace(KNetConfig().head, num_cls_fcs=2))
    _assert_loaded_equals_jax(KNet(cfg, device="cpu"), out, params, stats)


def test_strict_import_raises_on_a_leftover_key_in_both():
    sd = _reference_sd(False)
    sd["rpn_head.some_new_layer.weight"] = torch.randn(4, 4)
    with pytest.raises(KeyError):
        jti.import_torch_knet(sd, strict=True)
    with pytest.raises(KeyError, match="rpn_head.some_new_layer.weight"):
        import_torch_knet(sd, strict=True)
    # not strict: the key is left alone, as in JAX
    assert "rpn_head.some_new_layer.weight" not in import_torch_knet(sd)


def test_image_to_video_params_and_merge_match_jax():
    """An image checkpoint into the video model: the stages move to the
    top, the link and track layers keep the video model's init; merge
    overlays with a shape check in both packages."""
    sd = _reference_sd(False)
    params, stats = jti.import_torch_knet(sd)
    model = VideoKNet(VideoKNetConfig(), device="cpu")
    init = model.state_dict()
    merged = tck.merge_params(init, tck.image_to_video_params(import_torch_knet(sd)))
    model.load_state_dict(merged, strict=True)
    kept = {k for k in init if "attention_previous" in k or "link_ffn" in k
            or k.startswith("track_embed.")}
    assert kept and all(merged[k] is init[k] for k in kept)
    got = state_dict_to_flax(model, {k: v for k, v in model.state_dict().items()
                                     if k not in kept})
    want = flatten_variables({"params": jck.image_to_video_params(params),
                              "batch_stats": stats})
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)

    # merge_params: an overlay of a subset, a new key added, a shape mismatch raising
    jt = {"a": {"w": np.zeros((2, 3), np.float32), "b": np.ones(3, np.float32)}}
    ji = {"a": {"w": np.full((2, 3), 2.0, np.float32), "c": np.ones(1, np.float32)}}
    want = flatten_variables(jck.merge_params(jt, ji))
    got = tck.merge_params({"a.w": torch.zeros(2, 3), "a.b": torch.ones(3)},
                           {"a.w": torch.full((2, 3), 2.0), "a.c": torch.ones(1)})
    assert {k.replace(".", "/"): v.numpy() for k, v in got.items()}.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k.replace(".", "/")])
    with pytest.raises(ValueError):
        jck.merge_params(jt, {"a": {"w": np.zeros((3, 2), np.float32)}})
    with pytest.raises(ValueError, match="a.w"):
        tck.merge_params(got, {"a.w": torch.zeros(3, 2)})


def test_load_torch_file_matches_jax(tmp_path):
    sd = {"a.weight": torch.randn(3, 4), "a.bias": torch.randn(3), "n": torch.tensor(7)}
    for i, obj in enumerate(({"state_dict": sd, "meta": {"epoch": 3}}, sd)):
        path = str(tmp_path / f"ckpt{i}.pth")
        torch.save(obj, path)
        got, want = tck.load_torch_file(path), jck.load_torch_file(path)
        assert list(got) == list(want) == list(sd)
        for k in sd:
            assert torch.equal(got[k], want[k])


# --------------------------------------------------------------- backbones


def _basic_resnet_sd(depth: int, gen: torch.Generator) -> dict:
    """torchvision-named BasicBlock ResNet-18 / 34 (UniTrack's zoo)."""
    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[depth]
    sd = {"conv1.weight": torch.randn(64, 3, 7, 7, generator=gen)}

    def bn(pre, c):
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"{pre}.{leaf}"] = torch.randn(c, generator=gen)
        sd[f"{pre}.running_var"] = torch.rand(c, generator=gen) + 0.5

    bn("bn1", 64)
    cin = 64
    for s, (n, w) in enumerate(zip(blocks, (64, 128, 256, 512)), start=1):
        for b in range(n):
            pre = f"layer{s}.{b}"
            sd[f"{pre}.conv1.weight"] = torch.randn(w, cin, 3, 3, generator=gen)
            bn(f"{pre}.bn1", w)
            sd[f"{pre}.conv2.weight"] = torch.randn(w, w, 3, 3, generator=gen)
            bn(f"{pre}.bn2", w)
            if cin != w:
                sd[f"{pre}.downsample.0.weight"] = torch.randn(w, cin, 1, 1, generator=gen)
                bn(f"{pre}.downsample.1", w)
            cin = w
    return sd


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_import_appearance_resnet_matches_jax(depth):
    """torchvision-named ResNets into the UniTrack zoo's AppearanceResNet
    (all four layers kept)."""
    gen = torch.Generator().manual_seed(depth)
    sd = rsd.resnet50_sd(gen, prefix="") if depth == 50 else _basic_resnet_sd(depth, gen)
    sd["bn1.num_batches_tracked"] = torch.tensor(3)
    params, stats = jck.import_torch_resnet(sd, prefix="")
    out = tck.import_torch_resnet(sd, prefix="")
    _assert_loaded_equals_jax(AppearanceResNet(depth, remove_layers=()), out, params, stats)


def test_import_backbone_resnet_and_fpn_match_jax():
    """mmdet's `backbone.` R-50 into the port's ResNet, `neck.` FPN into FPN."""
    gen = torch.Generator().manual_seed(1)
    sd = {**rsd.resnet50_sd(gen), **rsd.fpn_sd(gen)}
    params, stats = jck.import_torch_resnet(sd)
    _assert_loaded_equals_jax(ResNet(50), tck.import_torch_resnet(sd), params, stats)
    _assert_loaded_equals_jax(FPN(), tck.import_torch_fpn(sd), jck.import_torch_fpn(sd), {})


def test_import_hrnet_matches_jax_and_rejects_leftovers():
    torch.manual_seed(1)
    net = THRNet(w=18).eval()
    _randomize_bn(net)
    sd = dict(net.state_dict())
    params, stats = jck.import_torch_hrnet(sd, width=18)
    out = tck.import_torch_hrnet(sd)
    _assert_loaded_equals_jax(HRNetEncoder(width=18), out, params, stats)
    sd["final_layer.0.weight"] = torch.zeros(1)  # dead in the reference: skipped
    tck.import_torch_hrnet(sd)
    sd["stage2.0.branches.0.0.conv9.weight"] = torch.zeros(1)
    with pytest.raises(KeyError):
        jck.import_torch_hrnet(sd, width=18)
    with pytest.raises(KeyError, match="conv9"):
        tck.import_torch_hrnet(sd)


# ------------------------------------------------------------ own checkpoints


def _fresh(cfg, seed: int):
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return create_train_state(model, make_optimizer(model, steps_per_epoch=1000))


def _snapshot(state) -> dict:
    opt = state.optimizer.adamw
    out = {f"param/{k}": v.clone() for k, v in state.model.state_dict().items()}
    for g, group in enumerate(opt.param_groups):
        out[f"lr/{g}"] = torch.tensor(group["lr"], dtype=torch.float64)
        for i, p in enumerate(group["params"]):
            for k, v in opt.state[p].items():
                out[f"adamw/{g}/{i}/{k}"] = v.clone()
    out["step"] = torch.tensor(state.step)
    return out


@pytest.mark.parametrize("drop_path", [False, True], ids=["tiny", "swin_drop_path"])
def test_resume_is_bit_equal_to_straight_training(tmp_path, drop_path):
    cfg = tg.tiny_cfg()
    if drop_path:
        cfg = dataclasses.replace(train_check.swin_check_cfg(cfg), backbone_drop_path_rate=0.3)
    batches = [make_synthetic_batch(cfg, 1, (64, 96), seed=i, device="cpu") for i in range(3)]

    def gen():
        return torch.Generator().manual_seed(5) if drop_path else None

    straight, g = _fresh(cfg, 0), gen()
    for b in batches:
        straight, want_losses = train_step(straight, b, g)

    state, g = _fresh(cfg, 0), gen()
    for b in batches[:2]:
        state, _ = train_step(state, b, g)
    path = tck.save_checkpoint(str(tmp_path), state, step=2, generator=g)
    assert path.endswith("step_2")
    g2 = torch.Generator().manual_seed(99) if drop_path else None
    resumed = tck.restore_checkpoint(path, _fresh(cfg, 1), generator=g2)
    before = _snapshot(state)
    got = _snapshot(resumed)
    assert got.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(got[k], v), k
    resumed, got_losses = train_step(resumed, batches[2], g2)
    assert {k: float(v) for k, v in got_losses.items()} == \
        {k: float(v) for k, v in want_losses.items()}
    want, got = _snapshot(straight), _snapshot(resumed)
    assert got.keys() == want.keys() and int(got["step"]) == 3
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_restore_asks_for_a_generator_the_checkpoint_lacks(tmp_path):
    state = _fresh(tg.tiny_cfg(), 0)
    path = tck.save_checkpoint(str(tmp_path), state)
    tck.restore_checkpoint(path, _fresh(tg.tiny_cfg(), 1))
    with pytest.raises(KeyError):
        tck.restore_checkpoint(path, _fresh(tg.tiny_cfg(), 1), generator=torch.Generator())
