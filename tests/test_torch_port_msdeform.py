"""The MSDeformAttn pixel decoder (`models/msdeform_decoder.py`) and its
sampling (`ops/sampling.py`) against the JAX package, on the CPU. The
deformable neck inside a tiny KNet and KNetVIS: `tests/test_torch_port_image.py`.

- `bilinear_sample` within 1e-6 relative on points inside, on the edge of
  and outside the map (zero padding); `ms_deform_attn_core` within 1e-5
  relative at random offsets, at zero offsets (the reference points: pixel
  centres) and at points pushed outside the map, and its gradients with
  respect to the values, the locations and the attention weights within
  1e-5 relative of `jax.grad`'s (the port sums the levels in another order).
- `MSDeformAttention` (random, nonzero sampling offsets) and the decoder
  with one encoder layer on MiT-b0-wide levels: within 1e-5 relative; the
  encoder's LayerNorms are torch's two-pass ones against flax's one-pass
  (ROADMAP 3.3), their inputs within a few standard deviations of zero.

Weights are made by the port (flax's default initializers) and carried to
flax (`state_dict_to_flax`); the decoder trees are held against JAX's init
in `tests/test_torch_port_image.py`. JAX's three jitted functions compile in
parallel threads.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_common import assert_rel_close, perturb_norms, port_of, t

from video_knet_tpu.models import msdeform_decoder as jdec
from video_knet_tpu.ops import sampling as jsampling
from video_knet_tpu_torch.models import layers as tl
from video_knet_tpu_torch.models import msdeform_decoder as tdec
from video_knet_tpu_torch.ops import sampling as tsampling
from video_knet_tpu_torch.utils.convert import state_dict_to_flax

HW = (64, 96)
SHAPES = [(6, 9), (3, 5), (2, 3)]  # three ragged levels
M, P, D = 8, 4, 4  # heads, points, head width


def _flax_of(model: torch.nn.Module) -> dict:
    flat = state_dict_to_flax(model, model.state_dict())
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


# ---------------------------------------------------------------- sampling


def test_bilinear_sample_inside_edge_and_outside():
    rng = np.random.RandomState(0)
    feat = rng.randn(5, 7, 3).astype(np.float32)
    ys = rng.uniform(-2.0, 6.5, size=(4, 11)).astype(np.float32)
    xs = rng.uniform(-2.0, 8.5, size=(4, 11)).astype(np.float32)
    # on the last row / column and half a pixel beyond the first ones
    ys[0, :4] = [4.0, -0.5, 3.999, -1.0]
    xs[0, :4] = [6.0, -0.5, 6.5, 2.0]
    want = jsampling.bilinear_sample(jnp.asarray(feat), jnp.asarray(ys), jnp.asarray(xs))
    got = tsampling.bilinear_sample(t(feat), t(ys), t(xs))
    assert_rel_close(got, want, 1e-6, "bilinear_sample")
    outside = (ys <= -1) | (ys >= 5) | (xs <= -1) | (xs >= 7)
    assert outside.any() and np.all(np.asarray(want)[outside] == 0)


def _core_inputs(kind: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    b, q, l = 2, 13, len(SHAPES)
    values = [rng.randn(b, h, w, M, D).astype(np.float32) for h, w in SHAPES]
    if kind == "zero":  # the reference points: every pixel centre of level 0
        h, w = SHAPES[0]
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        pts = np.stack([gx, gy], -1).reshape(-1, 2)[:q].astype(np.float32)
        locs = np.broadcast_to(pts[None, :, None, None, None, :], (b, q, M, l, P, 2)).copy()
    else:
        locs = rng.uniform(0.0, 1.0, size=(b, q, M, l, P, 2)).astype(np.float32)
        if kind == "outside":  # about half the points off the map, some far off
            locs = locs * 2.4 - 0.7
    logits = rng.randn(b, q, M, l * P).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return values, locs, attn.reshape(b, q, M, l, P).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "zero", "outside"])
def test_ms_deform_attn_core(kind):
    values, locs, attn = _core_inputs(kind)
    want = _runs()["want"]["core"](values, locs, attn)
    got = tsampling.ms_deform_attn_core([t(v) for v in values], t(locs), t(attn))
    assert got.shape == (2, 13, M * D)
    assert_rel_close(got, want, 1e-5, f"ms_deform_attn_core ({kind})")


def test_ms_deform_attn_core_gradients():
    r = _runs()
    values, locs, attn, cot = r["grad_in"]
    want = r["want"]["grad"]
    tv = [t(v).requires_grad_() for v in values]
    tlc, tat = t(locs).requires_grad_(), t(attn).requires_grad_()
    (tsampling.ms_deform_attn_core(tv, tlc, tat) * t(cot)).sum().backward()
    for i, v in enumerate(tv):
        assert_rel_close(v.grad, want[0][i], 1e-5, f"d value level {i}")
    assert_rel_close(tlc.grad, want[1], 1e-5, "d locations")
    assert_rel_close(tat.grad, want[2], 1e-5, "d attention weights")


# ---------------------------------------------------------------- modules


def _attention_case():
    """MSDeformAttention with random (nonzero) sampling offsets on ragged
    levels: (port module, its flax variables, inputs)."""
    c, b = M * D * 2, 2
    rng = np.random.RandomState(3)
    attn = tdec.MSDeformAttention(c, M, len(SHAPES))
    tl.init_parameters(attn, torch.Generator().manual_seed(0))
    with torch.no_grad():  # flax starts the offsets at zero; move them
        attn.sampling_offsets.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    q = sum(h * w for h, w in SHAPES)
    inputs = (rng.randn(b, q, c).astype(np.float32),
              rng.uniform(0.0, 1.0, size=(b, q, len(SHAPES), 2)).astype(np.float32),
              [rng.randn(b, h, w, c).astype(np.float32) for h, w in SHAPES])
    return attn.eval(), {"params": _flax_of(attn)["params"]}, inputs


def _decoder_case():
    """The decoder at MiT-b0's widths (32/64/160/256) over 16x24 .. 2x3
    levels, one encoder layer, norms perturbed."""
    widths = (32, 64, 160, 256)
    rng = np.random.RandomState(4)
    dec = tdec.MSDeformAttnPixelDecoder(in_channels=widths, num_layers=1)
    tl.init_parameters(dec, torch.Generator().manual_seed(0))
    with torch.no_grad():
        dec.layer0.self_attn.sampling_offsets.weight.normal_(
            0.0, 0.02, generator=torch.Generator().manual_seed(1))
    variables = perturb_norms(_flax_of(dec), seed=5)
    feats = [rng.randn(2, 64 // s, 96 // s, c).astype(np.float32)
             for s, c in zip((4, 8, 16, 32), widths)]
    return port_of(dec, variables), variables, (feats,)


def _jax_core_grad(values, locs, attn, cot):
    def loss(vals, lc, at):
        return jnp.sum(jsampling.ms_deform_attn_core(vals, lc, at) * cot)

    return jax.grad(loss, argnums=(0, 1, 2))(values, locs, attn)


def _grad_case():
    values, locs, attn = _core_inputs("outside", seed=1)
    cot = np.random.RandomState(2).randn(2, 13, M * D).astype(np.float32)
    return values, locs, attn, cot


@functools.lru_cache(maxsize=None)
def _runs() -> dict:
    """JAX's attention, one-layer decoder and sampling gradient, each jitted
    and compiled in a thread of its own as soon as it is traced; the port's
    counterparts on the same inputs."""
    attn, attn_vars, attn_in = _attention_case()
    dec, dec_vars, dec_in = _decoder_case()
    grad_in = _grad_case()
    jfns = {"decoder": (jdec.MSDeformAttnPixelDecoder(num_layers=1).apply, (dec_vars, *dec_in)),
            "attn": (jdec.MSDeformAttention(M * D * 2, M).apply, (attn_vars, *attn_in)),
            "grad": (_jax_core_grad, grad_in),
            "core": (jsampling.ms_deform_attn_core, _core_inputs("random"))}
    with ThreadPoolExecutor(len(jfns)) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile)
                   for k, (fn, args) in jfns.items()}
    want = {k: futures[k].result()(*args) for k, (_, args) in jfns.items() if k != "core"}
    want["core"] = futures["core"].result()  # one shape for all three input kinds

    def torch_args(args):
        return [[t(x) for x in a] if isinstance(a, list) else t(a) for a in args]

    with torch.no_grad():
        got = {"attn": attn(*torch_args(attn_in)), "decoder": dec(*torch_args(dec_in))}
    return dict(want=want, got=got, grad_in=grad_in)


def test_ms_deform_attention():
    r = _runs()
    assert_rel_close(r["got"]["attn"], r["want"]["attn"], 1e-5, "MSDeformAttention")


def test_decoder_one_layer_on_mit_b0_levels():
    got, want = _runs()["got"]["decoder"], _runs()["want"]["decoder"]
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, 64 // 4 // 2 ** i, 96 // 4 // 2 ** i, 256)
        assert_rel_close(g, w, 1e-5, f"decoder level {i}")
