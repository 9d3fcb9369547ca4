"""Data-parallel checks: R ranks at B/R each against one process at B.

`run_ranks(world, specs, tmp)` starts `world` processes of this module
(the environment torchrun gives its workers: RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE), which join one process group through a `file://` store
under `tmp` (no port, so concurrent runs cannot collide), run
`train_steps` on their rows of each spec's global batches and write their
results; it returns, rank by rank, the list of results (one a spec). A
spec {"kind": "gather", "items"} instead runs
`parallel/distributed.py:allgather_results` on rank r's `items[r]`, and
{"kind": "any_rank", "flags"} `any_rank` on rank r's `flags[r]` (the
preemption flag's agreement), and {"kind": "replicated"} `mesh.replicated`
on a module filled with rank + 1. `launch(world, argv, tmp)` starts
any module's command line that way (the train CLIs under a file:// init).
`train_steps(mesh, device, spec)` in one process is the reference;
`run_reference(specs, tmp)` runs it for each spec in a process of its own
(the CPU, no process group), recording the ReLU decisions for the ranks
to replay.

A spec: {"kind": "vps" | "vis" | "image", "cfg", "seed" (the weights'
init), "weights" (optional: a state dict loaded over it),
"batches" (global batches of CPU tensors, one a step), "opt" (keyword
arguments of `make_optimizer`), "ddp" (optional, one rank only: "plain"
runs the one-process step in the rank's process, "none" the step over the
mesh without DistributedDataParallel (its collectives only), "find_unused"
DDP walking the autograd graph for unused parameters whatever the model;
by default the step as the port runs it), "timing" (optional: a rank
writes only the losses, milliseconds and launches back), "relus" (optional:
per step, the one-process step's ReLU decisions over the global batch,
recorded by `train_steps(..., record=)`, which each rank replays on its
rows so that a ReLU input within rounding of zero cannot send the two
backwards down different sides of its kink)}. A result: the per-step loss
dicts, the first step's gradients before the clip, the model's final
parameters and buffers (CPU tensors), each step's milliseconds (host
clock, the device synchronized around the step) and its kernel launches
(the wrappers' counts, set to 0 before the steps), the trainable
parameters' names and the model's `leaves_parameters_unused`; with "relus", whether
each step replayed every decision and how many elements its own decisions
would have sent the other way.

Run as a worker: `python -m video_knet_tpu_torch.tools.dp_check SPEC OUT_DIR`,
or as the reference: `... dp_check --reference SPEC OUT`. `... dp_check --cli
NAME ARGS...` runs the train CLI `video_knet_tpu_torch.tools.NAME` with ARGS
(under torchrun: `torchrun --nproc_per_node=2 -m
video_knet_tpu_torch.tools.dp_check --cli train_vps ...`) and prints this
rank's kernel launches as `LAUNCHES rank=R {...}` at the end.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import pickle
import subprocess
import sys
import time

import torch

from video_knet_tpu_torch.parallel.mesh import DataMesh, batch_sharding, shard_batch


def _model_and_step(kind: str, cfg, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    if kind == "vps":
        from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
        from video_knet_tpu_torch.train.vps import train_step

        return VideoKNet(cfg, generator=gen, device=device), train_step
    if kind == "vis":
        from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
        from video_knet_tpu_torch.train.vis import train_step

        return KNetVIS(cfg, generator=gen, device=device), train_step
    from video_knet_tpu_torch.models.knet import KNet
    from video_knet_tpu_torch.train.image import train_step

    return KNet(cfg, generator=gen, device=device), train_step


def rank_rows(decision: torch.Tensor, mesh: DataMesh, batch_size: int, kind: str) -> torch.Tensor:
    """This rank's rows of a tensor of the global batch: VPS's backbone,
    neck and init head see [ref; key], two slices of the global batch
    (`mesh.batch_blocks`); everything else is batch-major."""
    n = decision.shape[0]
    blocks = 2 if kind == "vps" and n == 2 * batch_size else 1
    per = n // blocks
    rows = batch_sharding(mesh, per)
    return torch.cat([decision[j * per:(j + 1) * per][rows] for j in range(blocks)])


class _Bare(torch.nn.Module):
    """Stands in for DistributedDataParallel: the wrapped module, called
    as is (one rank: the same step without DDP's bookkeeping)."""

    def __init__(self, module, **_):
        super().__init__()
        self.module = module

    def forward(self, *inputs):
        return self.module(*inputs)

    def register_comm_hook(self, *_):
        pass


@contextlib.contextmanager
def ddp_variant(variant: str, mesh: DataMesh):
    """While active, the train steps build DDP as `variant` says (see the
    module doc)."""
    parallel = torch.nn.parallel
    real = parallel.DistributedDataParallel
    if variant == "none":
        if mesh.world != 1:
            raise ValueError("a step without DDP sums no gradient: one rank only")
        parallel.DistributedDataParallel = _Bare
    elif variant == "find_unused":
        parallel.DistributedDataParallel = lambda *a, **k: real(
            *a, **{**k, "find_unused_parameters": True})
    try:
        yield
    finally:
        parallel.DistributedDataParallel = real


def _to(batch, device):
    if torch.is_tensor(batch):
        return batch.to(device)
    return type(batch)(*(_to(x, device) for x in batch))


def train_steps(mesh: DataMesh, device, spec: dict, record: list | None = None) -> dict:
    """`len(spec["batches"])` train steps of the spec's model on this rank's
    rows of each global batch (see the module doc). With `record`, each
    step's ReLU decisions are appended to it (the one-process reference,
    for the ranks to replay)."""
    from video_knet_tpu_torch.tools.train_check import relu_pattern
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state

    kind = spec["kind"]
    model, step = _model_and_step(kind, spec["cfg"], spec["seed"], device)
    if "weights" in spec:
        model.load_state_dict(spec["weights"], strict=True)
    state = create_train_state(model, make_optimizer(model, 1000, **spec.get("opt", {})), mesh)
    first: dict = {}
    optimizer_step = state.optimizer.step

    def keep_first_grads():
        if not first:
            first.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters() if p.grad is not None})
        optimizer_step()

    state.optimizer.step = keep_first_grads
    losses, replayed, differ, ms, launches = [], [], [], [], []
    cuda = torch.device(device).type == "cuda"
    reset_counts()
    for i, batch in enumerate(spec["batches"]):
        b = batch[0].shape[0]
        local = _to(shard_batch(mesh, batch), device)
        relus = spec.get("relus")
        if cuda:
            torch.cuda.synchronize()
        start, t0 = counts(), time.perf_counter()
        if record is not None:
            record.append([])
            with relu_pattern(record[-1]):
                state, out = step(state, local)
        elif relus is None:
            state, out = step(state, local)
        else:
            pattern = [rank_rows(d, mesh, b, kind) for d in relus[i]]
            with relu_pattern(pattern, replay=True) as stats:
                state, out = step(state, local)
            replayed.append(stats["calls"] == len(pattern))
            differ.append(stats["differ"])
        if cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        end = counts()
        launches.append({k: end[k] - start[k] for k in end})
        losses.append({k: float(v) for k, v in out.items()})
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return dict(losses=losses, grads=first, state=sd, replayed=replayed, differ=differ, ms=ms,
                launches=launches,
                trainable=[n for n, p in model.named_parameters() if p.requires_grad],
                declares_unused=getattr(model, "leaves_parameters_unused", False))


def reset_counts() -> None:
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    mask_ops.reset_launch_counts()
    hungarian.reset_launch_counts()


def counts() -> dict:
    """The kernel wrappers' launch counts of this process."""
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    return {**mask_ops.LAUNCHES, **hungarian.LAUNCHES}


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank_env(rank: int, world: int, threads: int = 1) -> dict:
    """torchrun's worker environment for one host, the repo on the path,
    `threads` intra-op threads a rank."""
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), PYTHONPATH=path, OMP_NUM_THREADS=str(threads))


def launch(world: int, argv: list[str], tmp: str, timeout: float = 600.0,
           threads: int = 1) -> list[str]:
    """`python -m <argv>` in `world` processes with torchrun's rank
    environment; returns each rank's output (standard output and errors).
    Raises if any rank fails."""
    procs = [subprocess.Popen([sys.executable, "-m", *argv], env=_rank_env(r, world, threads),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def run_ranks(world: int, specs: list[dict], tmp: str, timeout: float = 600.0,
              device: str = "cpu", backend: str | None = None, threads: int = 1) -> list[list]:
    """Each spec over `world` ranks joined through a file:// store in `tmp`
    (see the module doc), `threads` intra-op threads a rank: rank by rank,
    the list of the specs' results."""
    os.makedirs(tmp, exist_ok=True)
    spec_path, store = os.path.join(tmp, "dp_spec.pkl"), os.path.join(tmp, "dp_store")
    if os.path.exists(store):  # a file store is good for one group only
        os.remove(store)
    with open(spec_path, "wb") as f:
        pickle.dump(dict(specs=specs, device=device, backend=backend,
                         init="file://" + os.path.abspath(store)), f)
    try:
        launch(world, ["video_knet_tpu_torch.tools.dp_check", spec_path, tmp], tmp, timeout,
               threads)
    finally:
        os.remove(spec_path)
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"dp_rank_{r}.pkl")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        os.remove(path)
    return out


def run_reference(specs: list[dict], tmp: str, timeout: float = 600.0,
                  threads: int = 1) -> list[tuple]:
    """`train_steps` of each spec in one process of its own on the CPU: a
    list of (its result, the ReLU decisions it recorded, or replayed where
    the spec gives them)."""
    os.makedirs(tmp, exist_ok=True)
    spec_path, out = os.path.join(tmp, "ref_spec.pkl"), os.path.join(tmp, "ref_out.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(specs, f)
    env = {**_rank_env(0, 1, threads), "WORLD_SIZE": ""}
    proc = subprocess.run([sys.executable, "-m", "video_knet_tpu_torch.tools.dp_check",
                           "--reference", spec_path, out], env=env, capture_output=True,
                          text=True, timeout=timeout)
    os.remove(spec_path)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run exited {proc.returncode}:\n{proc.stdout[-2000:]}"
                           f"{proc.stderr[-4000:]}")
    with open(out, "rb") as f:
        result = pickle.load(f)
    os.remove(out)
    return result


def _reference(spec_path: str, out: str) -> None:
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    with open(spec_path, "rb") as f:
        specs = pickle.load(f)
    results = []
    for spec in specs:
        if "relus" in spec:  # replaying given decisions
            results.append((train_steps(DataMesh(), "cpu", spec), spec["relus"]))
            continue
        relus: list = []
        results.append((train_steps(DataMesh(), "cpu", spec, record=relus), relus))
    with open(out, "wb") as f:
        pickle.dump(results, f)


def _worker(spec_path: str, out_dir: str) -> None:
    from video_knet_tpu_torch.parallel import distributed

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    with open(spec_path, "rb") as f:
        job = pickle.load(f)
    device = distributed.initialize(job["device"], backend=job["backend"],
                                    init_method=job["init"])
    mesh = distributed.global_mesh()
    try:
        results = []
        for spec in job["specs"]:
            if spec["kind"] == "gather":
                results.append(distributed.allgather_results(
                    spec["items"][mesh.rank], os.path.join(out_dir, "gather")))
            elif spec["kind"] == "any_rank":
                results.append(distributed.any_rank(spec["flags"][mesh.rank]))
            elif spec["kind"] == "replicated":
                from video_knet_tpu_torch.parallel.mesh import replicated

                module = torch.nn.BatchNorm1d(3)
                with torch.no_grad():
                    for t in [*module.parameters(), *module.buffers()]:
                        t.fill_(mesh.rank + 1)
                results.append(replicated(mesh, module).state_dict())
            else:
                variant = spec.get("ddp", "ddp")
                on = DataMesh() if variant == "plain" else mesh
                with ddp_variant(variant, mesh):
                    res = train_steps(on, device, spec)
                if spec.get("timing"):
                    res = {k: res[k] for k in ("losses", "ms", "launches")}
                results.append(res)
        with open(os.path.join(out_dir, f"dp_rank_{mesh.rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        distributed.shutdown()


def _cli(name: str, argv: list[str]) -> None:
    from video_knet_tpu_torch.parallel import distributed

    reset_counts()
    try:
        importlib.import_module(f"video_knet_tpu_torch.tools.{name}").main(argv)
        # one write: torchrun merges the ranks' standard outputs
        rank = os.environ.get("RANK", "0")
        sys.stdout.write(f"LAUNCHES rank={rank} {json.dumps(counts())}\n")
        sys.stdout.flush()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(*sys.argv[2:4])
    elif sys.argv[1] == "--cli":
        _cli(sys.argv[2], sys.argv[3:])
    else:
        _worker(*sys.argv[1:3])
