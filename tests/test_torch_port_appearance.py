"""UniTrack's appearance-model zoo (`models/video/appearance.py`,
`models/video/hrnet.py`) against the JAX package, on the CPU.

Weights: JAX's variables tree (`jax.eval_shape` of its init, so no init is
compiled) filled with seeded values, norms and BatchNorm statistics away
from their init, carried to the port by `utils/convert.py` (strict). The
encoders run at small sizes: ResNet-18 and ResNet-50 at 32x48, HRNet-w18 at
64x96 (return stages 2 and 3, one weight tree), each output within 1e-4 of
its largest magnitude. The random generator has no JAX counterpart value
for value: it is held by shape, range and determinism under one seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, perturb_norms

from video_knet_tpu.models.video import appearance as ja
from video_knet_tpu_torch.models.video import appearance as ta
from video_knet_tpu_torch.models.video import hrnet as th
from video_knet_tpu_torch.utils.convert import load_flax_variables

ENCODERS = [("resnet18", (32, 48), {}), ("resnet50", (32, 48), {}),
            ("hrnet_w18", (64, 96), {"return_stage": 2}),
            ("hrnet_w18", (64, 96), {"return_stage": 3})]


def _seeded_variables(model, hw, seed):
    """JAX's variables tree for `model`, every leaf drawn from `seed`:
    kernels ~ N(0, 1 / fan_in), biases small, norms perturbed."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3), jnp.float32))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return np.zeros(s.shape, np.float32) if name in ("bias", "mean") else np.ones(
            s.shape, np.float32)

    return perturb_norms(jax.tree_util.tree_map_with_path(leaf, shapes), seed)


@functools.lru_cache(maxsize=None)
def _weights(name: str, hw: tuple):
    return _seeded_variables(ja.make_appearance_model(name), hw, seed=len(name))


@pytest.mark.parametrize("name,hw,kw", ENCODERS,
                         ids=[f"{n}-{kw.get('return_stage', '')}" for n, _, kw in ENCODERS])
def test_encoder_matches_jax(name, hw, kw):
    variables = _weights(name, hw)
    x = np.random.RandomState(0).randn(1, *hw, 3).astype(np.float32)
    want = np.asarray(ja.make_appearance_model(name, **kw).apply(variables, x))
    model = load_flax_variables(ta.make_appearance_model(name, device="cpu", **kw), variables)
    got = ta.make_appearance_fn(model)(x)
    # stride 8 and the encoder's width (ResNet-18 layer3: 256; ResNet-50:
    # 1024; HRNet-w18's head stage 2: 512, stage 3: 1024)
    assert got.shape == want.shape == (1, hw[0] // 8, hw[1] // 8, model.out_channels)
    assert not got.requires_grad
    assert_rel_close(got, want, 1e-4, f"{name} {kw}")


def test_zoo_names_and_widths():
    assert ta.make_appearance_model("resnet34", device="cpu").out_channels == 256
    assert ta.make_appearance_model("resnet18", device="cpu",
                                    remove_layers=()).out_channels == 512
    hr = ta.make_appearance_model("hrnet_w32", device="cpu", return_stage=0)
    assert isinstance(hr, th.HRNetEncoder) and hr.widths == (32, 64, 128, 256)
    assert hr.out_channels == 128
    with pytest.raises(ValueError):
        ta.make_appearance_model("vgg16", device="cpu")


def test_hrnet_stage0_shrinks_with_antialias():
    """return_stage 0 (stride 4) is resized down to the stride-8 map, as
    `jax.image.resize` antialiases: shape and finite values."""
    model = ta.make_appearance_model("hrnet_w18", device="cpu", return_stage=0)
    out = ta.make_appearance_fn(model)(np.zeros((1, 64, 96, 3), np.float32))
    assert out.shape == (1, 8, 12, 128) and torch.isfinite(out).all()


def test_random_generator_shape_range_determinism():
    """The reference's `jax.random.uniform` values cannot be reproduced in
    torch; its shape ([N, round(H/8), round(W/8), 128]), its range [0, 1),
    fresh values each frame and a repeatable sequence can."""
    jm = ja.make_appearance_model("random")
    img = np.zeros((1, 60, 100, 3), np.float32)
    jshape = jm.apply({}, img, 0).shape
    fn = ta.make_appearance_fn(ta.make_appearance_model("random", device="cpu"))
    a, b = fn(img), fn(img)
    assert a.shape == b.shape == jshape == (1, 8, 12, 128)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0 and not torch.equal(a, b)
    again = ta.make_appearance_fn(ta.make_appearance_model("random", device="cpu"))
    assert torch.equal(again(img), a) and torch.equal(again(img), b)
