"""The control of the output check: the plain reference put in the
program's place, computed in the nearest precision below the
configuration's (TF32 for float32 with TF32 off), read at the cell's own
size beside the program's readings on the same seeds.

    python3 -m vkbench.control --workload <cell> --seeds <n> [<n> ...] [--seconds 10]

Each seed is one run of the cell (`vkbench.run.run`) in this process with
a short window; after it the reference serves or trains what was checked
twice, in float32 and in TF32, and both the program's and the control's
numbers are printed, one JSON line a seed. A limit lies between the
program's largest reading and the control's smallest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from vkbench import common, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    common.set_environment()
    import torch

    cell = common.cell(args.workload)
    if not torch.cuda.is_available():
        print("vkbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, work, numbers = run.run(cell, seed, args.seconds, False, "cuda", t0,
                                        modes=("program", "control"))
        print(json.dumps({"seed": seed, "program": numbers["program"],
                          "control": numbers["control"], "correct": result["correct"],
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "work": work}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
