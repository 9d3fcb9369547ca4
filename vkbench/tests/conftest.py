"""Shared helpers of the benchmark's own tests: cells cut to a size the
CPU runs in seconds, and a run of one."""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vkbench import common, run  # noqa: E402

TINY_HW = (64, 96)
SEED = 2**31 + 77  # wider than 32 signed bits, as the benchmark's seeds are


def tiny_cell(name: str, hw=TINY_HW) -> dict:
    """`name` at `hw`, with the traffic cut to a few rounds or steps."""
    cell = common.cell(name)
    cell["config"]["frame_hw"] = list(hw)
    mix = cell["traffic"]
    if mix["driver"] == "serve_streams":
        mix.update(streams=2, ring_rounds=4, warmup_rounds=2, check_every=3, profiled_rounds=2)
    else:
        mix.update(staged=3, profiled_steps=1, window_check_span=2)
    return cell


def tiny_run(name: str, trace: bool = False, device: str = "cpu", seconds: float = 2.0,
             modes=("program",), seed: int = SEED, hw=TINY_HW):
    torch.set_num_threads(4)
    return run.run(tiny_cell(name, hw), seed, seconds, trace, device, time.perf_counter(),
                   modes=modes)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
