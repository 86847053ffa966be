"""Measure what the host gives the input pipeline: one JSON line.

    python -m vit_search_torch.tools.loader_check [--classes 64] [--batch 32]
                                                  [--workers 1,2,4,8]

On a synthetic folder (``make_synthfolder``: ``--classes`` x 4 images at
256 px, in a temporary directory):

- ``transform_ms``: the train transform's cost per image on one core (JPEG
  decode, RandomResizedCrop to 224 px, flip, RandAugment
  ``rand-m9-mstd0.5-inc1``);
- ``loader_imgs_per_s``: ``data.DataLoader`` over the folder at batch
  ``--batch``, per worker backend and worker count (workers beyond the
  host's cores are skipped);
- ``python_scaling``: the speedup of a pure-Python loop run in 1, 2, 4, ...
  processes at once, how many cores the host really runs in parallel;
- the host's ``os.cpu_count()`` and scheduler affinity.

It uses no card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import sys
import tempfile
import time


def _spin(n: int) -> float:
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i * i
    return time.perf_counter() - t0


def python_scaling(counts, n: int = 5_000_000) -> dict:
    """Speedup of ``count`` processes each running the same loop."""
    out = {}
    for count in counts:
        with multiprocessing.get_context("spawn").Pool(count) as pool:
            pool.map(_spin, [1000] * count)   # the workers are up
            t0 = time.perf_counter()
            each = pool.map(_spin, [n] * count)
            out[count] = count * min(each) / (time.perf_counter() - t0)
    return out


def main(argv=None) -> dict:
    import numpy as np
    from PIL import Image

    from .. import data
    from .make_synthfolder import generate

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--classes", type=int, default=64)
    parser.add_argument("--per-class", type=int, default=4)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--workers", default="1,2,4,8")
    args = parser.parse_args(argv)
    cores = len(os.sched_getaffinity(0))
    counts = [w for w in (int(v) for v in args.workers.split(",")) if w <= cores]
    out = {"cpu_count": os.cpu_count(), "cores": cores}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            generate(root, num_classes=args.classes, train_per_class=args.per_class,
                     val_per_class=0, size=256, workers=max(counts))
        out["make_synthfolder_s"] = time.perf_counter() - t0
        ds = data.ImageFolderDataset(os.path.join(root, "train"), data.TrainTransform(224))
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for path, _ in ds.samples:
            with Image.open(path) as img:
                ds.transform(img, rng)
        out["transform_ms"] = 1e3 * (time.perf_counter() - t0) / len(ds)
        out["loader_imgs_per_s"] = {}
        for backend in ("process", "thread"):
            for workers in counts:
                loader = data.DataLoader(ds, data.ShardedSampler(len(ds), 1, 0), args.batch,
                                         num_workers=workers, worker_backend=backend)
                t0 = time.perf_counter()
                seen = sum(len(labels) for _, labels in loader)
                out["loader_imgs_per_s"][f"{backend} {workers}"] = (
                    seen / (time.perf_counter() - t0))
    out["python_scaling"] = python_scaling(counts)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
