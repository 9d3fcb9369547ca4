"""The packed device->host transfer of the serving payloads (`utils/tree.py`).

A payload crosses to the host as one contiguous uint8 buffer (`pack`) and
comes back as numpy views (`unpack`). On the CPU the same pack and unpack
run with no copy. Each of the three payloads (device tracker; host tracker,
compact; host tracker, full decode), single and stacked as a window, must
come back leaf for leaf equal, in dtype and bits, to a per-leaf `.numpy()`
with bf16 re-floated to float32. No tolerance: the transfer is a byte copy.
"""

import dataclasses

import numpy as np
import pytest
import torch

from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.utils.tree import (
    ALIGN,
    HostCopy,
    pack,
    to_host,
    tree_map,
    tree_stack,
    unpack,
)

torch.set_num_threads(1)  # one intra-op thread a worker, as tests/torch_port_common.py


def _per_leaf(tree):
    def leaf(x):
        if not torch.is_tensor(x):
            return x
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return tree_map(leaf, tree)


def _assert_same(got, want, path="payload"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (path, got.dtype)
        assert got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path  # bits
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def payloads():
    model = tg.tiny_model("cpu")
    frames = [torch.from_numpy(f) for f in tg.eval_frames()[:2]]
    cfg = tg.tiny_cfg()
    full = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, fast_decode=False))
    out = {}
    for name, c, tracker in (("device", cfg, "quasi_dense"), ("compact", cfg, "quasi_dense_host"),
                             ("full", full, "quasi_dense_host")):
        pipe = VPSInferencePipeline(model, c, tg.HW, tracker_type=tracker, device="cpu")
        out[name] = [pipe._step(f, i == 0) for i, f in enumerate(frames)]
    return out


# every leaf dtype of each payload (the id map is uint8 on the device
# tracker's wire for up to 255 segments, int16 on the compact one)
DTYPES = {
    "device": {torch.uint8, torch.bool, torch.int16, torch.int32, torch.float32},
    "compact": {torch.bool, torch.int16, torch.int32, torch.float32, torch.bfloat16},
    "full": {torch.bool, torch.int32, torch.int64, torch.float32},
}


@pytest.mark.parametrize("stacked", [False, True], ids=["frame", "window"])
@pytest.mark.parametrize("kind", ["device", "compact", "full"])
def test_payload_round_trip_is_bit_exact(payloads, kind, stacked):
    payload = tree_stack(payloads[kind]) if stacked else payloads[kind][0]
    _assert_same(to_host(payload), _per_leaf(payload))
    buf, layout = pack(payload)
    assert buf.dtype == torch.uint8 and buf.dim() == 1 and buf.numel() == layout.nbytes
    assert all(s.offset % ALIGN == 0 for s in layout.leaves)
    spans = sorted((s.offset, s.offset + s.nbytes) for s in layout.leaves)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no overlap
    assert {s.dtype for s in layout.leaves} == DTYPES[kind]


def test_every_dtype_and_shape_round_trips():
    rng = np.random.RandomState(0)
    # bf16 halfway cases and extremes cross bit for bit and re-float exactly
    bf = torch.tensor([1.0, -2.5, 3.0e38, -1e-38, 0.0, float("inf")]).to(torch.bfloat16)
    tree = {
        "bool": torch.from_numpy(rng.rand(3, 5) > 0.5),
        "u8": torch.from_numpy(rng.randint(0, 255, 7).astype(np.uint8)),
        "i8": torch.tensor([-3, 4], dtype=torch.int8),
        "i16": torch.from_numpy(rng.randint(-2**15, 2**15, (2, 3)).astype(np.int16)),
        "i32": torch.tensor(7, dtype=torch.int32),  # 0-d
        "i64": torch.arange(5, dtype=torch.int64),
        "f16": torch.randn(3, dtype=torch.float16),
        "f32": torch.randn(4, 3).t(),  # not contiguous
        "f64": torch.randn(2, dtype=torch.float64),
        "bf16": bf,
        "empty": torch.zeros((0, 4), dtype=torch.int16),
        "other": [None, "tag", 3],
    }
    host = to_host(tree)
    _assert_same(host, _per_leaf(tree))
    assert host["bf16"].dtype == np.float32
    np.testing.assert_array_equal(host["bf16"], bf.float().numpy())


def test_cpu_transfer_is_the_packed_buffer_itself():
    tree = {"a": torch.arange(6, dtype=torch.int32), "b": torch.ones(3, dtype=torch.bool)}
    copy = HostCopy(tree)
    assert copy.event is None  # no copy, no event on the CPU
    host = copy.result()
    assert np.shares_memory(host["a"], copy.host.numpy())
    buf, layout = pack(tree)
    _assert_same(unpack(buf.numpy(), layout), host)


def test_pack_rejects_mixed_devices():
    with pytest.raises(ValueError):
        pack({"a": torch.zeros(2), "b": torch.zeros(2, device="meta")})
