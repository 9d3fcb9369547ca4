"""Runs one cell of the benchmark of `video_knet_tpu_torch` once.

    python3 -m vkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (program, seeded weights and inputs, warm-up), then the timed
window, then the check of the window's outputs against the plain
reference in `vkbench/reference/`, then one JSON line on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with `--trace 0`, its per-layer metrics with `--trace 1`), `device`,
`breakdown` (traced runs) and `check` (each number compared, with its
limit). The numbers compared are also the last lines on standard error.

The cell, its configuration, traffic mix, limits and metrics are found by
name from `BENCHMARK.json`: see `vkbench/README.md`. Exits non-zero with no
result line without as many CUDA devices as the cell asks for, or when a
module of JAX or of the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from vkbench import common  # noqa: E402


def process_start() -> float:
    """perf_counter's reading at this process's start (Linux), or at the
    first line of this module elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return T_IMPORT - max(age - (time.perf_counter() - T_IMPORT), 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def device_info(device, count) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(device))}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        modes=("program",)) -> tuple[dict, list[str], dict]:
    """One run of `cell`. Returns (the result line's object, the lines that
    say what work the seed gave, every mode's check numbers)."""
    import torch

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    drv = common.driver(cell["traffic"]).Driver(cell, seed, seconds, trace, device)
    drv.setup()
    setup_s = drv.t_start - t0
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    if trace:
        rec, attempted = drv.window_traced()
        metrics = {}
        for m in cell["per_layer"]:
            value = common.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values, attempted = drv.window()
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    info = device_info(device, cell["chips"])
    info["memory_peak_bytes"] = max(info["memory_peak_bytes"], int(peak))
    extra = {}
    if trace:
        from vkbench import trace as tr

        info["busy_s"] = tr.busy_s(rec["events"])
        info["window_s"] = rec["profiled_s"]
        extra["breakdown"] = tr.breakdown(rec["events"])
        del rec
    failed = getattr(drv, "failed", 0)
    drv.release()
    t_check = time.perf_counter()
    numbers, work = drv.check(modes)
    work.append(f"output check: {time.perf_counter() - t_check:.1f} s")
    prev, parts = t0, []
    for name, t in drv.marks:
        parts.append(f"{name} {t - prev:.2f}")
        prev = t
    work.append("set-up s: " + ", ".join(parts))
    compared = {k: {"value": numbers["program"][k], "limit": lim}
                for k, lim in cell["limits"].items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    work.append("also read (no limit): " + ", ".join(
        f"{k} {v!r}" for k, v in numbers["program"].items() if k not in compared))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info, **extra, "check": compared}
    return result, work, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t0 = process_start()
    common.set_environment()
    import torch

    cell = common.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"vkbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, work, _ = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = common.forbidden_modules()
    if found:
        print(f"vkbench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    for line in work:
        print(line, file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
