"""JAX-side jobs of `tests/test_torch_port_train_cli.py`, each run in a
process of its own (`python tests/torch_port_jax_jobs.py SPEC OUT`).

Tracing a JAX train step holds the GIL for tens of seconds, so JAX jobs
in threads of the test process run one after another; in processes they
overlap. SPEC is a pickle of {"job": name, **arguments}; OUT gets a pickle
of the job's result. Every process runs JAX on one host CPU device, with a
persistent compilation cache under the temporary directory (`TMPDIR`).

Jobs:
- `cli`: the repo root's `tools/{name}.py` in process (`run_jax`), with
  config factories patched to the given configs, the given models' `init`
  returning the given variables (the CLI's optimizer needs the params
  tree), the train state replicated on a one-device mesh from the start
  (each train step compiles once) and `save_checkpoint` keeping the
  state's parameters and BatchNorm statistics in the result; optionally a
  `train_vps` whose step only counts, a `--resume-from` at a given step,
  and the first step's gradient with a `freeze_detector` step from it;
  optionally waiting for a file before the CLI starts;
  returns {"out": printed text, "params": {work dir: flat params},
  "batch_stats": {work dir: flat statistics}, "batches": image digests,
  "first": {"params", "grads", "stepped"}}.
- `direct_vps`: the VPS fp32 and bf16 losses on the synthetic batch.
- `direct_vis`: the VIS fp32 and bf16 losses on a given clip.
- `live_bn_resnet`: ResNet-50 in train mode with `norm_eval=False` (live
  BatchNorm): outputs, gradients, new batch statistics, ReLU decisions.
- `sharded_vps`: `make_sharded_train_step` on a two-device `data` mesh
  (the job's process gets two virtual CPU devices), a few steps: losses,
  ReLU decisions, the first step's gradient, final state.
- `vis_live_bn`: the VIS loss with live BatchNorm and its new statistics.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import os
import pickle
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _setup_jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", False)
    jax.config.update("jax_platforms", "cpu")  # as tests/conftest.py forces it
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(tempfile.gettempdir(), "vknet_jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def _flat(tree) -> dict:
    import numpy as np
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def cli(name: str, argv: list, configs: dict, inits: dict, still: bool = False,
        resume_step: int | None = None, keep_grads: bool = False,
        wait_for: str | None = None) -> dict:
    """configs: {(module, factory name): config}; inits: {(module, class
    name): variables}. With `still`, `train_vps`'s step only counts (the
    parameters and statistics stay as they are) and keeps a digest of each
    batch's images; with `resume_step`, `--resume-from` gives the state at
    that step (no checkpoint is read); with `keep_grads`, the first step's
    parameters and gradient come back, and one `freeze_detector` step of
    the CLI's optimizer from them. With `wait_for`, the CLI starts once that
    file exists (the test writes the checkpoints the CLI reads while this
    process imports)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    import video_knet_tpu.parallel.mesh as jmesh
    import video_knet_tpu.train.optim as joptim
    import video_knet_tpu.train.train_state as jts
    import video_knet_tpu.train.vps as jtvps
    import video_knet_tpu.utils.checkpoint as jck
    from torch_port_common import run_jax

    for (mod, attr), cfg in configs.items():
        setattr(importlib.import_module(mod), attr, lambda cfg=cfg: cfg)
    for (mod, cls), variables in inits.items():
        setattr(getattr(importlib.import_module(mod), cls), "init",
                lambda self, *a, variables=variables, **k: variables)
    mesh = jmesh.make_mesh(n_data=1, n_model=1)
    jmesh.make_mesh = lambda *a, **k: mesh
    # The train state on the mesh from the start, as every step returns it:
    # a CLI's first state is off the mesh, so its second step would trace
    # and compile the step again.
    create_train_state, merge_params = jts.create_train_state, jck.merge_params
    on_mesh = lambda tree: jax.device_put(tree, jmesh.replicated(mesh))  # noqa: E731
    jts.create_train_state = lambda *a, **k: on_mesh(create_train_state(*a, **k))
    jck.merge_params = lambda *a, **k: on_mesh(merge_params(*a, **k))
    params, stats, batches = {}, {}, []

    def keep_state(path, state, *, step=None):
        work_dir = os.path.dirname(os.path.abspath(path))
        stats[work_dir] = _flat(state.batch_stats)
        if not still:  # a still run's parameters are its loaded ones
            params[work_dir] = _flat(state.params)
        return path

    def still_step(*args, **kwargs):
        def step(state, batch):
            batches.append(hashlib.sha1(np.asarray(batch.img).tobytes()).hexdigest())
            return state._replace(step=state.step + 1), {}
        return step

    first = {}
    make_optimizer = joptim.make_optimizer

    def keeping_optimizer(params, *args, **kwargs):
        """The CLI's optimizer, whose update hands its first gradient and
        parameters to the host; its `freeze_detector` twin kept aside."""
        tx = make_optimizer(params, *args, **kwargs)
        first["frozen"] = make_optimizer(params, *args, **{**kwargs, "freeze_detector": True})

        def update(grads, state, params=None):
            jax.debug.callback(lambda g, p: first.setdefault("at", (g, p)), grads, params)
            return tx.update(grads, state, params)

        return optax.GradientTransformation(tx.init, update)

    jck.save_checkpoint = keep_state
    if still:
        jtvps.make_sharded_train_step = still_step
    if resume_step is not None:
        jck.restore_checkpoint = lambda path, target=None: target._replace(
            step=jnp.asarray(resume_step, jnp.int32))
    if keep_grads:
        joptim.make_optimizer = keeping_optimizer
    deadline = time.monotonic() + 600
    while wait_for is not None and not os.path.exists(wait_for):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{wait_for} never appeared")
        time.sleep(0.05)
    out = {"out": run_jax(name, argv), "params": params, "batch_stats": stats,
           "batches": batches}
    if keep_grads:
        grads, at = first["at"]
        tx = first["frozen"]

        @jax.jit
        def frozen_step(p, g):
            updates, _ = tx.update(g, tx.init(p), p)
            return optax.apply_updates(p, updates)

        out["first"] = dict(params=_flat(at), grads=_flat(grads),
                            stepped=_flat(frozen_step(at, grads)))
    return out


def direct_vps(vps_cfg, vps_vars, hw) -> dict:
    """The VPS fp32 and bf16 losses on the synthetic batch."""
    import jax

    import video_knet_tpu.train.vps as jtvps
    from video_knet_tpu.models.video.knet_vps import VideoKNet

    batch = jtvps.make_synthetic_batch(vps_cfg, 1, hw)
    out = {}
    for key, cfg in (("t32", vps_cfg), ("t16", dataclasses.replace(vps_cfg, bf16_train=True))):
        loss = jtvps.make_vps_loss_fn(VideoKNet(cfg, train=True), cfg)
        out[key] = float(jax.jit(lambda p, loss=loss: loss(
            p, vps_vars.get("batch_stats", {}), batch)[0])(vps_vars["params"]))
    return out


def direct_vis(vis_cfg, vis_vars, vis_clip, vis_gt) -> dict:
    """The VIS fp32 and bf16 losses on the given clip."""
    import jax
    import jax.numpy as jnp

    import video_knet_tpu.train.vis as jtvis
    from video_knet_tpu.models.vis.knet_vis import ClipGT, KNetVIS

    clip = jnp.asarray(vis_clip)
    gt = ClipGT(*(jnp.asarray(x) for x in vis_gt))
    out = {}
    for key, cfg in (("t32", vis_cfg), ("t16", dataclasses.replace(vis_cfg, bf16_train=True))):
        loss = jtvis.make_vis_loss_fn(KNetVIS(cfg, train=True), cfg)
        out[key] = float(jax.jit(lambda p, loss=loss: loss(
            p, vis_vars.get("batch_stats", {}), clip, gt)[0])(vis_vars["params"]))
    return out


def live_bn_resnet(variables, x, cotangents) -> dict:
    """JAX ResNet-50(train=True, norm_eval=False, frozen_stages=1) on `x`
    with mutable batch statistics: the four outputs, the gradients of
    sum_i <out_i, cotangents_i> for the input and the parameters, the new
    batch statistics and the ReLU inputs' signs (`jax_pre_relu`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from torch_port_common import jax_pre_relu
    from video_knet_tpu.models.resnet import ResNet

    model = ResNet(depth=50, frozen_stages=1, norm_eval=False, train=True)

    def f(params, x):
        outs, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                                mutable=["batch_stats", "intermediates"],
                                capture_intermediates=jax_pre_relu)
        loss = sum(jnp.sum(o * c) for o, c in zip(outs, cotangents))
        return loss, (outs, upd)

    (_, (outs, upd)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    signs = jax.tree_util.tree_map(lambda v: np.asarray(v) > 0, upd["intermediates"])
    return dict(outs=[np.asarray(o) for o in outs], grad_x=np.asarray(gx),
                grads=_flat({"params": gp}), batch_stats=_flat({"batch_stats": upd["batch_stats"]}),
                relus=signs)


def sharded_vps(cfg, variables, batches) -> dict:
    """JAX's `make_sharded_train_step` on a two-device `data` mesh, one step
    a global batch (numpy fields of `VPSBatch`), the optimizer of its CLI
    (`make_optimizer(params, 1000, frozen_stages=...)`); the state put on
    the mesh first, so the step compiles once. The model is seen through a
    proxy that captures its ReLU inputs (`jax_pre_relu`) and the optimizer
    through one whose update hands its gradient to the host, both with
    `jax.debug.callback`. Returns each step's losses and ReLU decisions
    (the inputs' signs), the first step's gradient, and the final
    parameters and batch statistics."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    import video_knet_tpu.train.vps as jtvps
    from torch_port_common import jax_pre_relu
    from video_knet_tpu.models.video.knet_vps import VideoKNet
    from video_knet_tpu.ops.targets import PanopticGT
    from video_knet_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from video_knet_tpu.train.optim import make_optimizer
    from video_knet_tpu.train.train_state import create_train_state

    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    grads, relus = [], []
    model = VideoKNet(cfg, train=True)

    class Capturing:
        """`model` as the loss function calls it, with its ReLU inputs'
        signs handed to the host."""
        train = model.train

        def apply(self, variables, *args, mutable, **kwargs):
            out, upd = model.apply(variables, *args, mutable=[*mutable, "intermediates"],
                                   capture_intermediates=jax_pre_relu, **kwargs)
            upd = dict(upd)
            signs = jax.tree_util.tree_map(lambda v: v > 0, upd.pop("intermediates"))
            jax.debug.callback(lambda s: relus.append(host(s)), signs)
            return out, upd

    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    tx = make_optimizer(variables["params"], 1000, frozen_stages=cfg.frozen_stages)

    def update(g, opt_state, params=None):
        jax.debug.callback(lambda g: grads.append(host(g)), g)
        return tx.update(g, opt_state, params)

    keeping = optax.GradientTransformation(tx.init, update)
    state = jax.device_put(create_train_state(variables, keeping), replicated(mesh))
    step = jtvps.make_sharded_train_step(Capturing(), cfg, keeping, mesh)
    losses = []
    for img, ref_img, gt, ref_gt in batches:
        batch = jtvps.VPSBatch(jnp.asarray(img), jnp.asarray(ref_img),
                               PanopticGT(*map(jnp.asarray, gt)),
                               PanopticGT(*map(jnp.asarray, ref_gt)))
        with mesh:
            state, out = step(state, shard_batch(mesh, batch))
        losses.append({k: float(v) for k, v in out.items()})
    jax.effects_barrier()
    assert len(grads) == len(relus) == len(batches), (len(grads), len(relus))
    return dict(losses=losses, relus=relus, grads=_flat({"params": grads[0]}),
                params=_flat({"params": state.params}),
                batch_stats=_flat({"batch_stats": state.batch_stats}))


def vis_live_bn(cfg, variables, clip, gt) -> dict:
    """JAX's VIS loss (`make_vis_loss_fn`, live BatchNorm) on one clip batch:
    the losses and the new batch statistics."""
    import jax
    import jax.numpy as jnp

    import video_knet_tpu.train.vis as jtvis
    from video_knet_tpu.models.vis.knet_vis import ClipGT, KNetVIS

    loss = jtvis.make_vis_loss_fn(KNetVIS(cfg, train=True), cfg)
    total, (losses, new_bs) = jax.jit(lambda p, bs, c, g: loss(p, bs, c, g))(
        variables["params"], variables["batch_stats"], jnp.asarray(clip),
        ClipGT(*map(jnp.asarray, gt)))
    return dict(total=float(total), losses={k: float(v) for k, v in losses.items()},
                batch_stats=_flat({"batch_stats": new_bs}))


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    _setup_jax()
    spec_path, out_path = sys.argv[1:3]
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    result = {"cli": cli, "direct_vps": direct_vps, "direct_vis": direct_vis,
              "live_bn_resnet": live_bn_resnet, "sharded_vps": sharded_vps,
              "vis_live_bn": vis_live_bn}[spec.pop("job")](**spec)
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)
