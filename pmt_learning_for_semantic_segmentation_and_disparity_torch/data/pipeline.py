"""Input pipeline: threaded host-side loading and a prefetching copy to the
card (the port's counterpart of the JAX package's ``data/pipeline.py``).

``DataLoader`` and ``pad_to_bucket`` are the JAX package's: the same index
permutation, per-epoch seeding, ``pad_batch`` and ``valid``, and with
``process_index``/``process_count`` each rank loads only its slice of every
global batch. One change: each sample's draw (``StereoSegDataset.draw``:
its generator and the stateful class balancer's pick) is made on the
dispatching thread in sample order, and the worker threads only decode and
augment. So a batch never depends on which thread gets there first, and
the batches equal the JAX loader's at one worker; at more, the JAX loader's
balanced draws follow its threads' timing.
``prefetch_to_device``: a thread loads the next batches into pinned host
memory while the card works, and each is copied to the device with
``non_blocking``; ``prefetch_to_mesh`` does so for a rank's slice onto its
card. Arrays stay NHWC (the models read them channels_last).
"""
from __future__ import annotations

import concurrent.futures as futures
import queue
import threading
from typing import Dict, Iterator, Sequence

import numpy as np
import torch


def _stack(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = [k for k in samples[0] if k != "meta"]
    out = {k: np.stack([s[k] for s in samples]) for k in keys}
    out["meta"] = [s.get("meta") for s in samples]
    return out


def pad_to_bucket(batch: Dict[str, np.ndarray], bucket_hw) -> Dict[str, np.ndarray]:
    """Pad spatial dims up to a static eval bucket (the reference's 'crop
    [0,0] = full image' path is dynamic; one bucket keeps the shapes fixed).

    Adds a ``pad_mask`` (B,bh,bw,1) float map — 1 on real pixels, 0 on the
    padded border — which the eval metrics use to exclude padding from the
    report (the reference evaluates at native size, so padding must be
    metrically invisible)."""
    bh, bw = bucket_hw
    out = {}
    mask = None
    for k, v in batch.items():
        if k == "meta" or not isinstance(v, np.ndarray) or v.ndim != 4:
            out[k] = v
            continue
        _, h, w, _ = v.shape
        if h > bh or w > bw:
            v = v[:, :bh, :bw]
            h, w = v.shape[1:3]
        if mask is None:
            mask = np.zeros((v.shape[0], bh, bw, 1), np.float32)
            mask[:, :h, :w] = 1.0
        if (h, w) != (bh, bw):
            v = np.pad(v, ((0, 0), (0, bh - h), (0, bw - w), (0, 0)))
        out[k] = v
    if mask is not None:
        out["pad_mask"] = mask
    return out


class DataLoader:
    """Minimal epoch-based loader: shuffling, worker threads, drop_last."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        bucket_hw=None,
        pad_batch: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.bucket_hw = bucket_hw
        # pad_batch: repeat the last sample so every batch has batch_size
        # rows (one batch shape for every step, and every rank's slice
        # full); 'valid' in the batch dict records the true count.
        self.pad_batch = pad_batch
        # several ranks: batch_size is the GLOBAL batch; every rank draws the
        # same (seed-synchronized) index permutation but loads ONLY its
        # contiguous 1/process_count slice of each batch — the per-rank
        # DistributedSampler analogue (torch_implementation.py:772-790)
        # without ever materializing the global batch in one process.
        if batch_size % max(1, process_count):
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{process_count} processes")
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        # re-seed the per-sample augmentation stream like DistributedSampler
        # set_epoch does (torch_implementation.py:884)
        if hasattr(self.dataset, "seed"):
            self.dataset.seed = self.seed + epoch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        local = self.batch_size // self.process_count
        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, self.batch_size):
                chunk = idx[start : start + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    break
                valid = len(chunk)
                if self.pad_batch and valid < self.batch_size:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:],
                                          self.batch_size - valid)]
                    )
                # this rank's contiguous slice of the global batch
                chunk = chunk[self.process_index * local:
                              (self.process_index + 1) * local]
                # the class balancer's stateful draws here, in sample
                # order; the threads only decode and augment
                drawn = [self.dataset.draw(i) for i in chunk]
                samples = list(pool.map(lambda d: self.dataset.load(*d), drawn))
                batch = _stack(samples)
                if self.bucket_hw is not None:
                    batch = pad_to_bucket(batch, self.bucket_hw)
                batch["valid"] = valid
                yield batch


def _host_tensors(batch: Dict, pin: bool):
    """(tensors, extras) of a loader batch: every array as a tensor (pinned
    for an asynchronous copy to the card), and the host-only ``meta`` and
    ``valid``."""
    batch = dict(batch)
    extras = {"meta": batch.pop("meta", None), "valid": batch.pop("valid", None)}
    tensors = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            tensors[k] = t.pin_memory() if pin else t
    return tensors, extras


def prefetch_to_device(iterator, device: torch.device, size: int = 2):
    """Yields (batch on ``device``, {"meta", "valid"}) for each loader batch.
    A thread loads up to ``size`` batches ahead into (pinned) host memory;
    each is copied to the device with ``non_blocking``. An error in loading
    is raised here."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for batch in iterator:
                if not put(_host_tensors(batch, pin)):
                    return
            put(done)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, extras = item
            yield {k: v.to(device, non_blocking=True) for k, v in tensors.items()}, extras
    finally:
        stop.set()
        thread.join()


def prefetch_to_mesh(iterator, mesh, size: int = 2):
    """``prefetch_to_device`` onto the rank's card (``mesh.device``) of the
    rank's slice of each global batch: (slice on the card, {"meta",
    "valid"}), ``meta`` and ``valid`` (the global batch's count) on the
    host. The iterator loads only that slice: a ``DataLoader`` with
    ``process_index=mesh.rank`` and ``process_count`` the mesh's size, the
    JAX package's per-host loading with one process per card. Raises for an
    iterator of whole global batches on a mesh of several ranks."""
    from ..parallel.mesh import mesh_size

    got = (getattr(iterator, "process_index", 0), getattr(iterator, "process_count", 1))
    if got != (mesh.rank, mesh_size(mesh)):
        raise ValueError(f"prefetch_to_mesh on rank {mesh.rank} of {mesh_size(mesh)} needs a loader "
                         f"of that rank's slice, got process_index, process_count = {got}")
    return prefetch_to_device(iterator, mesh.device, size)
