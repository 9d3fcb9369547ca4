"""Threaded host-side train loader: decode -> transform -> pack -> device batch.

Counterpart of `video_knet_tpu/data/loader.py` (the reference's torch
DataLoader with worker subprocesses and the rank-sharding
DistributedSampler): a ThreadPoolExecutor of `num_threads` workers loads
sample pairs in parallel (the PNG codec's inflate and unfilter release the
GIL, `native/png_codec.py`) while the consumer runs the train step; a
bounded window keeps `prefetch` batches in flight.

Determinism and ranks: the epoch permutation and every per-sample
augmentation seed are drawn up front from the loader seed, so batches are
bit-identical for any thread count and equal JAX's loader's. Over ranks,
every rank walks the whole sequence of global batches of `batch_size` and
loads only its own rows of each (`mesh.batch_sharding`): the R ranks'
batches, stacked, are a one-process loader's row for row. The data `mesh`
is the given one, else that of an initialized `torch.distributed` process
group (`parallel/mesh.py:make_mesh`), else one process. Given
`process_index` and `process_count` instead, a process takes the strided
slice `batches[process_index::process_count]` of whole global batches,
as JAX's loader does. Batches have one shape:
images [B, H, W, 3] float32 at crop size, GT in fixed slots at the
mask-assign stride.

On CUDA the workers stack each batch into pinned host memory and the
consumer copies it to the card with `non_blocking=True` on its current
stream, so the copy is ordered before the train step that reads it.
`ThreadedLoader` holds this machinery; the VIS clip loader
(`data/vis_loader.py`) shares it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from video_knet_tpu_torch.config import VideoKNetConfig
from video_knet_tpu_torch.data.datasets import _DVPSScan
from video_knet_tpu_torch.data.panoptic_png import decode_panoptic_ann, load_png
from video_knet_tpu_torch.data.transforms import (
    apply_image_transform,
    apply_mask_transform,
    pack_panoptic_gt,
    sample_transform_params,
)
from video_knet_tpu_torch.ops.targets import PanopticGT
from video_knet_tpu_torch.parallel.mesh import DataMesh, batch_sharding, make_mesh
from video_knet_tpu_torch.train.vps import VPSBatch
from video_knet_tpu_torch.utils.device import resolve_device


class ThreadedLoader:
    """The threaded batch machinery both train loaders share: the up-front
    epoch permutation and seeds, the split over ranks, a pool of
    `num_threads` workers running `_load(index, rng)` with `prefetch`
    batches in flight, the stop event and error propagation, pinned host
    batches and the consumer's `non_blocking` copy. A subclass sets `ds`
    and `batch_size` and gives `_load`, `_assemble` (the host batch of a
    batch's items) and `_to_device`."""

    producer_name = "loader-producer"

    def __init__(self, *, seed: int, prefetch: int, num_threads: int,
                 process_index: int | None, process_count: int | None,
                 device: str | torch.device | None, mesh: DataMesh | None = None):
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.num_threads = max(1, num_threads)
        if mesh is None and (process_index is None or process_count is None):
            mesh = make_mesh()
        self.mesh = mesh
        if mesh is not None:  # every global batch, this rank's rows of it
            process_index, process_count = 0, 1
        self.process_index = process_index
        self.process_count = max(1, process_count)

    def _stack(self, arrays: list[np.ndarray]) -> torch.Tensor:
        """The host tensor of one batch field: pinned memory for CUDA."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.stack(arrays))
        first = torch.from_numpy(arrays[0])
        out = torch.empty((len(arrays), *first.shape), dtype=first.dtype, pin_memory=True)
        view = out.numpy()
        for i, a in enumerate(arrays):
            view[i] = a
        return out

    def _move(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, non_blocking=True)

    def _epoch_draws(self) -> tuple[np.ndarray, np.ndarray]:
        """An epoch's permutation and ALL its augmentation seeds, drawn up
        front: batches are reproducible regardless of thread count or host
        sharding."""
        order = self.rng.permutation(len(self.ds))
        return order, self.rng.randint(0, 2**31, size=len(order))

    def skip_epochs(self, n: int) -> None:
        """Draw `n` epochs' permutations and seeds unused, so that the next
        epoch is the one an unbroken run would see after `n` (a resumed
        run)."""
        for _ in range(n):
            self._epoch_draws()

    def __iter__(self) -> Iterator:
        order, seeds = self._epoch_draws()
        n_batches = len(order) // self.batch_size
        my_batches = list(range(self.process_index, n_batches, self.process_count))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        bsz = self.batch_size
        rows = slice(0, bsz) if self.mesh is None else batch_sharding(self.mesh, bsz)
        # consumers (especially tests) abandon the generator mid-epoch; without
        # a stop signal the producer blocks on q.put forever and leaks its
        # thread pool into the rest of the process
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    pending: list = []
                    it = iter(my_batches)

                    def submit(b: int):
                        sl = slice(b * bsz + rows.start, b * bsz + rows.stop)
                        pending.append([
                            pool.submit(self._load, int(i), np.random.RandomState(int(s)))
                            for i, s in zip(order[sl], seeds[sl])
                        ])

                    for _ in range(self.prefetch + 1):
                        b = next(it, None)
                        if b is None:
                            break
                        submit(b)
                    while pending and not stop.is_set():
                        futs = pending.pop(0)
                        if not put(self._assemble([f.result() for f in futs])):
                            return
                        b = next(it, None)
                        if b is not None:
                            submit(b)
                put(None)
            except BaseException as e:  # surface worker errors to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True, name=self.producer_name)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield self._to_device(batch)
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)


class VPSTrainLoader(ThreadedLoader):
    producer_name = "vps-loader-producer"

    def __init__(
        self,
        dataset: _DVPSScan,
        cfg: VideoKNetConfig,
        *,
        batch_size: int,
        crop_hw: tuple[int, int] = (384, 1248),
        img_scale: tuple[int, int] | None = None,
        seed: int = 0,
        prefetch: int = 2,
        num_threads: int = 4,
        process_index: int | None = None,
        process_count: int | None = None,
        device: str | torch.device | None = None,
        mesh: DataMesh | None = None,
    ):
        super().__init__(seed=seed, prefetch=prefetch, num_threads=num_threads,
                         process_index=process_index, process_count=process_count,
                         device=device, mesh=mesh)
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.crop_hw = crop_hw
        # base scale the random ratio multiplies (reference img_scale, e.g.
        # (384, 1248) KITTI-STEP / (720, 100000) VIP-Seg short-side-720);
        # defaults to the crop size, the release configs' choice.
        self.img_scale = img_scale if img_scale is not None else crop_hw

    def _load(self, idx: int, rng: np.random.RandomState):
        key, ref = self.ds.get_pair(idx, rng)
        p = sample_transform_params(rng, img_scale=self.img_scale)
        out = []
        for s in (key, ref):
            img = apply_image_transform(load_png(s.img), p, self.crop_hw)
            sem, inst = decode_panoptic_ann(
                s.ann, getattr(self.ds, "ann_mode", "kitti_rgb")
            )
            sem_t = apply_mask_transform(sem, p, self.crop_hw)
            inst_t = apply_mask_transform(inst, p, self.crop_hw, pad_value=0)
            gt = pack_panoptic_gt(
                sem_t,
                inst_t,
                thing_ids_in_seg=self.ds.thing_ids_in_seg,
                num_stuff_classes=self.cfg.num_stuff_classes,
                max_insts=self.cfg.max_insts,
                assign_stride=self.cfg.mask_assign_stride,
            )
            out.append((img, gt))
        return out

    def _assemble(self, pairs) -> VPSBatch:
        """Host batch of `pairs` (the consumer moves it to the device)."""
        def stack_gt(gts: list[PanopticGT]) -> PanopticGT:
            return PanopticGT(*[self._stack(list(x)) for x in zip(*gts)])

        imgs = self._stack([p[0][0] for p in pairs])
        ref_imgs = self._stack([p[1][0] for p in pairs])
        gt = stack_gt([p[0][1] for p in pairs])
        ref_gt = stack_gt([p[1][1] for p in pairs])
        return VPSBatch(imgs, ref_imgs, gt, ref_gt)

    def _to_device(self, batch: VPSBatch) -> VPSBatch:
        move = self._move
        return VPSBatch(move(batch.img), move(batch.ref_img),
                        PanopticGT(*map(move, batch.gt)), PanopticGT(*map(move, batch.ref_gt)))
