"""`import_torch_swin` (official Swin checkpoints onto the port's Swin)
against the JAX package's importer, on the CPU.

Synthetic official state dicts, built as `tests/test_swin_import.py` builds
them, in both layouts: a classification checkpoint (final `norm.` and
`head.` skipped, the per-stage out_norms left at their init) and a
detection checkpoint (`backbone.` prefix, per-stage `norm{i}`, here with
the absolute position embedding in its official [1, N, C] form). Each goes
through both importers, and the port's Swin-tiny forward at 64x96 equals
JAX's within 1e-5 relative. Strict mode raises on a leftover key.
"""

import numpy as np
import pytest
import torch
from test_swin_import import _ln, build_official_swin_sd
from torch_port_common import assert_rel_close, jax_swin_tiny_apply, t

from video_knet_tpu.utils.torch_import import import_torch_swin as jimport
from video_knet_tpu_torch.models.swin import SwinTransformer
from video_knet_tpu_torch.utils.torch_import import import_torch_swin

HW = (64, 96)
WIDTHS = (96, 192, 384, 768)


@pytest.fixture(scope="module")
def official():
    """A classification checkpoint's state dict (each test takes a copy)."""
    return build_official_swin_sd()


def _detection_sd(official):
    sd = dict(official)
    for k in ("head.weight", "head.bias", "norm.weight", "norm.bias"):
        del sd[k]
    for i, dim in enumerate(WIDTHS):
        _ln(sd, f"norm{i}", dim)
    sd["absolute_pos_embed"] = torch.randn(1, 56 * 56, WIDTHS[0]) * 0.05
    return {"backbone." + k: v for k, v in sd.items()}


def _compare(sd, ape: bool, out_norms_at_init: bool):
    torch.manual_seed(0)
    x = np.random.RandomState(0).randn(1, *HW, 3).astype(np.float32)
    model = SwinTransformer("tiny", ape=ape)
    if out_norms_at_init:  # all else comes from the checkpoint
        with torch.no_grad():
            for i in range(4):
                getattr(model, f"out_norm{i}").weight.fill_(1.0)
                getattr(model, f"out_norm{i}").bias.zero_()
    missing, unexpected = model.load_state_dict(import_torch_swin(sd, strict=True), strict=False)
    assert not unexpected
    assert sorted(missing) == (sorted(f"out_norm{i}.{p}" for i in range(4)
                                      for p in ("weight", "bias"))
                               if out_norms_at_init else [])
    params = jimport(sd, strict=True)
    if out_norms_at_init:  # flax's LayerNorm init, as the port's
        for i, dim in enumerate(WIDTHS):
            params[f"out_norm{i}"] = {"scale": np.ones(dim, np.float32),
                                      "bias": np.zeros(dim, np.float32)}
    want = jax_swin_tiny_apply(ape)({"params": params}, x)
    with torch.no_grad():
        got = model(t(x))
    for s, (a, b) in enumerate(zip(got, want)):
        assert_rel_close(a, b, 1e-5, f"stage {s}")
    return model


def test_classification_checkpoint_matches_jax(official):
    sd = dict(official)
    model = _compare(sd, ape=False, out_norms_at_init=True)
    # plain copies under the port's names: block j of stage i is pair j // 2
    torch.testing.assert_close(model.stage2_pairs[2].blk1.attn.proj.weight,
                               sd["layers.2.blocks.5.attn.proj.weight"], rtol=0, atol=0)
    torch.testing.assert_close(model.downsample1.reduction.weight,
                               sd["layers.1.downsample.reduction.weight"], rtol=0, atol=0)


def test_detection_checkpoint_with_ape_matches_jax(official):
    sd = _detection_sd(official)
    model = _compare(sd, ape=True, out_norms_at_init=False)
    assert tuple(model.absolute_pos_embed.shape) == (1, 56, 56, WIDTHS[0])
    torch.testing.assert_close(model.out_norm3.weight, sd["backbone.norm3.weight"],
                               rtol=0, atol=0)


def test_strict_import_raises_on_a_leftover_key(official):
    sd = dict(official)
    sd["layers.0.blocks.0.attn.extra.weight"] = torch.zeros(3)
    with pytest.raises(KeyError):
        import_torch_swin(sd, strict=True)
    out = import_torch_swin(sd)  # not strict: the key is left out
    assert not any("extra" in k for k in out)
    # the computed buffers and the classification head are consumed silently
    assert not any(k.endswith("relative_position_index") or k.startswith("head")
                   for k in out)
