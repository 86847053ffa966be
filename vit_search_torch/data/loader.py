"""Batched, prefetching data loader.

Port of vit_search_tpu/data/loader.py, the counterpart of the reference's
torch DataLoader (main.py:291-306, datasets.py:144-184): workers decode and
augment, batches are assembled as uint8 HWC numpy arrays (4x smaller
host-to-device copies than float32; the step normalizes on the device,
``train.engine.normalize``), and a bounded queue keeps a configurable number
of batches in flight ahead of the step loop. ``data.feed.prefetch_to_device``
moves them to the card.

Two worker backends (``worker_backend`` / ``VST_LOADER_BACKEND``):

- ``thread`` (default): PIL releases the GIL in its C codecs, but the
  numpy conversions/affines and ``np.stack`` serialize on the GIL: fine
  up to a few cores of decode work.
- ``process``: forked worker processes, the torch-DataLoader model the
  reference relies on. Scales host decode past the GIL.

The fork happens every epoch, after CUDA is initialized in the parent.
That is safe only while the workers touch nothing but numpy and PIL, which
is torch's own rule for its fork workers: datasets and transforms must hold
no torch tensors and call nothing of torch. Every dataset in
``data.datasets`` keeps to this.

Augmentation randomness is seeded per (seed, epoch, batch_index), so the
sample stream is bit-identical across worker counts AND backends, and equal
to the JAX package's under the same seed.

``drop_last`` semantics match the torch train loader; eval keeps the tail.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import signal
import threading
from typing import Iterable, Iterator, List, Tuple

import numpy as np

from .datasets import VisionDataset


def _load_batch(dataset, seed, epoch, bi, batch_indices):
    """Decode+augment one batch; rng depends only on (seed, epoch, bi)."""
    rng = np.random.default_rng((seed, epoch, bi))
    images, labels = [], []
    for idx in batch_indices:
        img, label = dataset.load(idx, rng)
        images.append(img)
        labels.append(label)
    return np.stack(images), np.asarray(labels, np.int32)


class _WorkerFailure:
    """Pickled marker a worker sends in place of a batch when it fails."""

    def __init__(self, formatted_traceback: str):
        self.formatted_traceback = formatted_traceback


def _process_worker(dataset, seed, epoch, job_q, res_q):
    import traceback

    # A worker is ended by SIGTERM; a handler the parent installed (the
    # CLI's preemption flag) must not outlive the fork and keep it alive.
    # The parent forks with SIGTERM blocked, so one sent before this line
    # waits for it and then ends the worker.
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGTERM})

    while True:
        job = job_q.get()
        if job is None:
            return
        bi, batch_indices = job
        try:
            item = _load_batch(dataset, seed, epoch, bi, batch_indices)
        except BaseException:
            # Ship the failure to the parent instead of dying silently —
            # a corrupt image must fail the run loudly, not wedge it.
            res_q.put((bi, _WorkerFailure(traceback.format_exc()), None))
            return
        res_q.put((bi, *item))


class DataLoader:
    def __init__(self, dataset: VisionDataset, sampler: Iterable[int],
                 batch_size: int, num_workers: int = 4, drop_last: bool = True,
                 prefetch_batches: int = 2, seed: int = 0,
                 worker_backend: str = None):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.seed = seed
        self.epoch = 0
        self.worker_backend = (worker_backend
                               or os.environ.get("VST_LOADER_BACKEND")
                               or "thread")
        if self.worker_backend not in ("thread", "process"):
            raise ValueError(f"unknown worker_backend "
                             f"{self.worker_backend!r}")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)  # type: ignore[arg-type]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        indices = list(iter(self.sampler))
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.worker_backend == "process":
            yield from self._iter_processes(batches)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        job_q: "queue.Queue" = queue.Queue()
        results = {}
        results_ready = threading.Condition()

        for i, b in enumerate(batches):
            job_q.put((i, b))
        stop = threading.Event()

        # workers park when this many finished batches are waiting, so a
        # slow consumer cannot make the results dict grow into the epoch
        backlog_limit = self.prefetch_batches + self.num_workers
        backlog_free = threading.Condition()

        def worker(worker_id: int):
            import traceback

            while not stop.is_set():
                with backlog_free:
                    while (len(results) >= backlog_limit
                           and not stop.is_set()):
                        backlog_free.wait(timeout=0.1)
                try:
                    bi, batch_indices = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = _load_batch(self.dataset, self.seed, self.epoch,
                                       bi, batch_indices)
                except BaseException:
                    # A corrupt image must fail the run loudly, not leave
                    # the emitter waiting on this batch index forever (same
                    # contract as the process backend's _WorkerFailure).
                    item = _WorkerFailure(traceback.format_exc())
                with results_ready:
                    results[bi] = item
                    results_ready.notify_all()
                if isinstance(item, _WorkerFailure):
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()

        def emitter():
            next_bi = 0
            try:
                while next_bi < len(batches) and not stop.is_set():
                    with results_ready:
                        while next_bi not in results and not stop.is_set():
                            results_ready.wait(timeout=0.1)
                        item = results.pop(next_bi, None)
                    if item is None:
                        return  # stopped before the batch arrived
                    with backlog_free:
                        backlog_free.notify_all()
                    # blocking put happens OUTSIDE the lock so workers can
                    # keep posting results while the consumer is slow
                    out_q.put(item)
                    next_bi += 1
            finally:
                out_q.put(None)

        emit_thread = threading.Thread(target=emitter, daemon=True)
        emit_thread.start()

        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, _WorkerFailure):
                    raise RuntimeError("data loader worker failed:\n"
                                       + item.formatted_traceback)
                yield item
        finally:
            stop.set()
            # drain so worker threads can exit
            while not job_q.empty():
                try:
                    job_q.get_nowait()
                except queue.Empty:
                    break


    def _iter_processes(self, batches: List[List[int]]):
        """Forked worker processes (torch-DataLoader model).

        Jobs are dealt in order; finished batches come back through a
        bounded queue (at most ``prefetch_batches + num_workers`` batches
        in flight, so a slow consumer bounds worker memory) and are
        re-sequenced here.  ``fork`` inherits the dataset without
        pickling; workers run only ``dataset.load`` (numpy/PIL).
        """
        ctx = multiprocessing.get_context("fork")
        job_q = ctx.Queue()
        res_q = ctx.Queue(maxsize=self.prefetch_batches + self.num_workers)
        for i, b in enumerate(batches):
            job_q.put((i, b))
        for _ in range(self.num_workers):
            job_q.put(None)
        procs = [ctx.Process(target=_process_worker,
                             args=(self.dataset, self.seed, self.epoch,
                                   job_q, res_q), daemon=True)
                 for _ in range(self.num_workers)]
        blocked = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
        try:
            for p in procs:
                p.start()
        finally:
            signal.pthread_sigmask(signal.SIG_SETMASK, blocked)
        buffered = {}
        next_bi = 0
        try:
            while next_bi < len(batches):
                try:
                    bi, images, labels = res_q.get(timeout=5.0)
                except queue.Empty:
                    # Liveness check: a worker killed by the OS (OOM,
                    # segfault in a codec) can't send a _WorkerFailure;
                    # without this the parent would block here forever.
                    dead = [p for p in procs
                            if not p.is_alive() and p.exitcode not in (0, None)]
                    if dead:
                        codes = [p.exitcode for p in dead]
                        raise RuntimeError(
                            f"data loader worker process(es) died with exit "
                            f"code(s) {codes} before batch {next_bi} arrived")
                    if not any(p.is_alive() for p in procs):
                        raise RuntimeError(
                            f"all data loader workers exited but batch "
                            f"{next_bi}/{len(batches)} never arrived")
                    continue
                if isinstance(images, _WorkerFailure):
                    raise RuntimeError(
                        "data loader worker failed:\n"
                        + images.formatted_traceback)
                buffered[bi] = (images, labels)
                while next_bi in buffered:
                    yield buffered.pop(next_bi)
                    next_bi += 1
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)


class PaddedEvalLoader:
    """All-sample eval stream with static batch shapes.

    Wraps an eval ``DataLoader`` (``drop_last=False``) over an ordered
    shard and yields ``(images, labels, valid)`` where every batch is
    padded to exactly ``batch_size`` rows (tail rows repeat the last real
    example) and ``valid`` is a float32 per-row mask that zeroes both the
    intra-batch tail padding and the sampler's cross-shard padding
    (``ShardedSampler.num_valid_samples``).  Downstream weighted-correct
    accounting then scores every dataset image exactly once across
    processes while every compiled program sees one static batch shape —
    the counterpart of the reference's padded ``OrderedDistributedSampler``
    + prefetch eval (datasets.py:154-184, driven by evo_search.py:189-196),
    minus its counted-duplicates bias.
    """

    def __init__(self, loader: "DataLoader", num_valid_samples: int):
        if loader.drop_last:
            raise ValueError("PaddedEvalLoader needs drop_last=False")
        self.loader = loader
        self.num_valid = int(num_valid_samples)
        self.batch_size = loader.batch_size

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        seen = 0
        for images, labels in self.loader:
            b = images.shape[0]
            valid = (np.arange(seen, seen + b) < self.num_valid)
            seen += b
            if b < self.batch_size:
                pad = self.batch_size - b
                images = np.concatenate(
                    [images, np.repeat(images[-1:], pad, axis=0)], axis=0)
                labels = np.concatenate(
                    [labels, np.repeat(labels[-1:], pad, axis=0)], axis=0)
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            yield images, labels, valid.astype(np.float32)

