"""Everything `BENCHMARK.json` names is found by name, and the file keeps
to the benchmark's contract."""

from __future__ import annotations

import os
import re

from vkbench import common

B = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "-m", "vkbench.run"]
    assert B["paths"] == ["vkbench"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(open(os.path.join(common.ROOT, "BENCHMARK.json")).read()) <= 64 * 1024


def test_every_cell_finds_its_files():
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        cell = common.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert hasattr(common.driver(cell["traffic"]), "Driver")
        assert cell["limits"], "a cell compares at least one number"
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_config_file_matches_its_entry():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("vkbench/") and NAME.match(c["name"])
        conf = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))


def test_metrics_keep_to_the_contract():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    assert e2e["setup_s"]["bound"] == 0.25
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in B["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        assert hasattr(common.reader(m["name"]), "read")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_serve_and_train_metrics_stay_in_their_cells():
    """A `.serve` metric sits in serving cells, a `.train` one in training
    cells. Load is offered at fixed rates, so the serving metrics split
    over a cell above capacity (`serve_fps`) and one below it
    (`frame_p95_ms`); each per-layer metric sits in cells that report the
    metric it moves (`test_metrics_keep_to_the_contract`)."""
    e2e = {m["name"]: set(m.get("workloads", [])) for m in B["end_to_end"]}
    for m in B["per_layer"]:
        if m["name"].endswith(".serve"):
            assert set(m["workloads"]) <= e2e["serve_fps"] | e2e["frame_p95_ms"]
        if m["name"].endswith(".train"):
            assert set(m["workloads"]) <= e2e["train_step_ms"]


def test_layers_are_named_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    assert layers == {"serving pipeline", "frame step", "backbone and neck", "train step",
                      "loss block", "kernels", "device", "whole step"}
