"""What every run of the benchmark shares: finding a cell's files by name,
the cache directories, the program's configuration checked against the
configuration file, the seeded weights, and the scan for JAX.

Everything here reads `BENCHMARK.json` and files under `vkbench/`; a new
configuration, traffic mix or per-layer metric is a new file found by its
name, never an edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "vkbench")
CACHE = os.path.join(ROOT, ".vkbench_cache")
# top-level module names that may not be loaded when a run reports
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "video_knet_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> dict:
    """The workload `name` with its configuration file, its traffic mix, its
    limits and the metrics it reports."""
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(m):
        return name in m.get("workloads", [name])

    return dict(
        name=name, chips=w["chips"], config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
        run_seconds=bench["run_seconds"],
    )


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict):
    return load_module(os.path.join(HERE, "traffic", traffic["driver"] + ".py"),
                       "vkbench_driver_" + traffic["driver"])


def reader(metric: str):
    """`metrics/<metric>.py`; for a metric `<base>.<family>` (such as
    `mfu.train`) with no file of its own, the reader its family shares,
    `metrics/<base>.py`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        metric = metric.rsplit(".", 1)[0]
        path = os.path.join(HERE, "metrics", metric + ".py")
    return load_module(path, "vkbench_metric_" + metric.replace(".", "_"))


def set_environment() -> None:
    """Before torch is imported: every compiler cache at a fixed path
    inside the checkout, and one host thread for intra-op work, so that a
    run's host side is one process with few threads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------ configuration

# where a number of the configuration file lives in the program's config
PORT_PATH = {"num_heads": "head.num_heads", "mask_upsample_stride": "head.mask_upsample_stride",
             "max_per_img": "test.max_per_img", "instance_score_thr": "test.instance_score_thr",
             "overlap_thr": "test.overlap_thr", "drop_path_rate": "backbone_drop_path_rate",
             "assigner_cls_weight": "assigner.cls_weight",
             "assigner_dice_weight": "assigner.dice_weight",
             "assigner_mask_weight": "assigner.mask_weight"}
NOT_IN_PORT = ("optim", "thing_ids")


def port_config(conf: dict):
    """The program's preset with the file's overrides, held against every
    number of the file's `model` (ValueError on a difference)."""
    from video_knet_tpu_torch.configs import get_config

    cfg = get_config(conf["preset"])
    for group, fields in conf.get("overrides", {}).items():
        group_cfg = dataclasses.replace(getattr(cfg, group), **fields)
        cfg = dataclasses.replace(cfg, **{group: group_cfg})
    for key, want in conf["model"].items():
        if key in NOT_IN_PORT:
            continue
        got = cfg
        for part in PORT_PATH.get(key, key).split("."):
            got = getattr(got, part)
        if isinstance(want, dict):
            got = {k: getattr(got, k) for k in want}
        if isinstance(got, tuple):
            got = list(got)
        if got != want:
            raise ValueError(
                f"{conf['name']}: {key} is {got!r} in the program, {want!r} in the file")
    return cfg


def make_weights(template: dict, seed: int, device, kernel_std: float = 1.0) -> dict:
    """Seeded weights for every entry of `template` ({name: shape}), made on
    `device` in a few large draws: flax's default initialisers (lecun
    truncated normal for kernels, truncated normal 0.02 for Swin's bias
    tables, normal init kernels, the focal prior on the class biases, unit
    norm scales, zero biases and BatchNorm statistics (0, 1))."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    trunc, normal = [], []
    for name, shape in template.items():
        if name.endswith("relative_position_bias_table"):
            trunc.append((name, shape, 0.02 / 0.87962566103423978))
        elif name.endswith("init_kernels"):
            normal.append((name, shape, kernel_std))
        elif len(shape) >= 2 and name.endswith("weight"):
            fan_in = math.prod(shape[1:])
            trunc.append((name, shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978))
    out = {}
    for leaves, draw in ((trunc, "trunc"), (normal, "normal")):
        if not leaves:
            continue
        sizes = [math.prod(s) for _, s, _ in leaves]
        flat = torch.empty(sum(sizes), device=device)
        if draw == "trunc":
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            flat.normal_(0.0, 1.0, generator=gen)
        stds = torch.tensor([s for _, _, s in leaves], device=device)
        flat *= stds.repeat_interleave(torch.tensor(sizes, device=device))
        for (name, shape, _), part in zip(leaves, flat.split(sizes)):
            out[name] = part.view(shape)
    for name, shape in template.items():
        if name in out:
            continue
        if name.endswith("fc_cls.bias"):
            value = -4.59511985013459  # focal prior 0.01
        elif name.endswith(("weight", "running_var")):
            value = 1.0
        else:
            value = 0.0
        out[name] = torch.full(shape, value, device=device)
    return {name: out[name] for name in template}
