"""Generate an on-disk ImageFolder-style dataset for accuracy validation.

A copy of vit_search_tpu/tools/make_synthfolder.py: the same arguments
write the same files.

No real dataset ships with the repository, so end-to-end recipe
validation (the workloads at reduced scale) uses a procedural
dataset that is *learnable but not trivial* under the full ImageNet
augmentation pipeline:

- each class is defined by 3 prototype textures — mixtures of random
  low-frequency sinusoidal gratings and Gaussian blobs drawn from a
  per-class seed (global structure survives RandomResizedCrop / flips /
  RandAugment color ops);
- each sample is a random convex combination of its class prototypes,
  randomly shifted (rolled), with additive noise.

Layout matches the ImageNet convention the data stack consumes:
``root/train/<class>/*.jpg`` and ``root/val/<class>/*.jpg`` (plus
``build_subsets`` can split train into sub-train/sub-val for search).

Usage: python -m vit_search_torch.tools.make_synthfolder ROOT \
          [--classes 100] [--train 200] [--val 50] [--size 176] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image


def _class_prototypes(cls_seed: int, size: int, n_proto: int = 3) -> np.ndarray:
    """(n_proto, size, size, 3) float32 textures in [0, 1]."""
    rng = np.random.default_rng(cls_seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    protos = []
    for _ in range(n_proto):
        img = np.zeros((size, size, 3), np.float32)
        for _ in range(4):  # sinusoidal gratings, class-specific freq/angle
            freq = rng.uniform(1.5, 8.0)
            theta = rng.uniform(0, np.pi)
            phase = rng.uniform(0, 2 * np.pi)
            wave = np.sin(2 * np.pi * freq
                          * (np.cos(theta) * xx + np.sin(theta) * yy) + phase)
            color = rng.uniform(0.1, 1.0, size=(3,)).astype(np.float32)
            img += wave[..., None] * color
        for _ in range(3):  # Gaussian blobs at class-specific positions
            cy, cx = rng.uniform(0.15, 0.85, size=2)
            sigma = rng.uniform(0.08, 0.2)
            blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                            / (2 * sigma ** 2)))
            color = rng.uniform(-1.0, 1.0, size=(3,)).astype(np.float32)
            img += 1.5 * blob[..., None] * color
        img -= img.min()
        img /= max(img.max(), 1e-6)
        protos.append(img)
    return np.stack(protos)


def _render_sample(protos: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One uint8 sample: convex prototype mix + roll + noise."""
    w = rng.dirichlet(np.ones(len(protos)))
    img = np.tensordot(w, protos, axes=1)
    size = img.shape[0]
    img = np.roll(img, rng.integers(0, size, size=2), axis=(0, 1))
    img += rng.normal(scale=0.08, size=img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _render_class(root: str, split: str, count: int, c: int, size: int, seed: int,
                  quality: int) -> None:
    cls = f"class{c:04d}"
    cls_dir = os.path.join(root, split, cls)
    os.makedirs(cls_dir, exist_ok=True)
    if not count:
        return
    protos = _class_prototypes(seed * 1_000_003 + c, size)
    rng = np.random.default_rng((seed, c, split == "val"))
    for i in range(count):
        img = _render_sample(protos, rng)
        Image.fromarray(img).save(os.path.join(cls_dir, f"{cls}_{i:05d}.jpg"), quality=quality)


def generate(root: str, num_classes: int = 100, train_per_class: int = 200,
             val_per_class: int = 50, size: int = 176, seed: int = 0,
             quality: int = 87, workers: int = 1) -> None:
    """Write the folder; ``workers`` processes (spawned: the caller may
    hold threads) render the classes. Each class is seeded on its own, so
    the files do not depend on ``workers``."""
    for split, count in (("train", train_per_class), ("val", val_per_class)):
        jobs = [(root, split, count, c, size, seed, quality) for c in range(num_classes)]
        if workers > 1:
            import multiprocessing

            with multiprocessing.get_context("spawn").Pool(workers) as pool:
                pool.starmap(_render_class, jobs)
        else:
            for job in jobs:
                _render_class(*job)
        print(f"{split}: {num_classes} classes x "
              f"{count} images at {size}px -> {os.path.join(root, split)}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root")
    p.add_argument("--classes", type=int, default=100)
    p.add_argument("--train", type=int, default=200)
    p.add_argument("--val", type=int, default=50)
    p.add_argument("--size", type=int, default=176)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    generate(args.root, num_classes=args.classes, train_per_class=args.train,
             val_per_class=args.val, size=args.size, seed=args.seed)


if __name__ == "__main__":
    main()
