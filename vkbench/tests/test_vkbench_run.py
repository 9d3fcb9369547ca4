"""A run's last line, its refusals, and the scan for JAX."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, tiny_run

from vkbench import common

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("cell", ["r50_kitti.serve8", "swinb_vipseg.train"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cpu_run_gives_the_contract_keys(cell, trace):
    result, work, _ = tiny_run(cell, trace=trace)
    keys = KEYS[:-1] + (["breakdown"] if trace else []) + KEYS[-1:]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) <= {m["name"] for m in common.cell(cell)["per_layer"]}
    else:
        assert set(result["metrics"]) == {m["name"] for m in common.cell(cell)["end_to_end"]}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    for c in result["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)
    assert work


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"video_knet_tpu_torch": 1, "video_knet_tpu_torch.models": 1, "jaxtyping": 1,
            "flaxen": 1, "numpy": 1}
    assert common.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "video_knet_tpu.ops": 1, "optax": 1, "jaxlib": 1, "flax": 1})
    assert common.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib", "optax",
                                             "video_knet_tpu.ops"]


def _cli(cwd):
    return subprocess.run([sys.executable, "-m", "vkbench.run", "--workload", "r50_kitti.serve8",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(os.path.join(ROOT, "vkbench"), tmp_path / "vkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
