"""Datasets: ImageNet-style folders, CIFAR-100, iNaturalist, synthetic.

A copy of vit_search_tpu/data/datasets.py. Datasets hold numpy arrays and
file paths only, never torch tensors: the loader's process backend forks
workers after CUDA is initialized (see ``data.loader``).

Parity with the reference's dataset constructors (datasets.py:28-101):
- ``IMNET``: ImageFolder layout; with ``use_holdout`` the train/val splits
  switch to ``sub-train``/``sub-val`` (datasets.py:77-91),
- ``CIFAR100``: the standard python-pickle distribution read from disk,
- ``INAT``/``INAT19``: iNaturalist 2018/2019 JSON-annotation layout with
  category-level label granularity (datasets.py:28-66),
- ``SYNTHETIC``: deterministic in-memory dataset for tests/CPU bring-up
  (capability the reference lacks; replaces its need for real data in CI).

Datasets expose ``__len__``/``load(index, rng) -> (uint8 HWC, label)`` and a
``num_classes`` attribute; decode+augment happens in loader workers.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, List, Optional, Tuple

import numpy as np
from PIL import Image

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


class VisionDataset:
    num_classes: int = 0

    def __len__(self) -> int:
        raise NotImplementedError

    def load(self, index: int, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        raise NotImplementedError


class ImageFolderDataset(VisionDataset):
    """<root>/<class_name>/<image> layout (torchvision ImageFolder parity)."""

    def __init__(self, root: str, transform: Callable):
        self.root = root
        self.transform = transform
        classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in classes:
            cdir = os.path.join(root, cls)
            for entry in sorted(os.scandir(cdir), key=lambda e: e.name):
                if entry.name.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((entry.path, self.class_to_idx[cls]))
        self.num_classes = len(classes)

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int, rng: np.random.Generator):
        path, label = self.samples[index]
        with Image.open(path) as img:
            return self.transform(img, rng), label


class CIFAR100Dataset(VisionDataset):
    """Reads the cifar-100-python pickle distribution from ``root``."""

    num_classes = 100

    def __init__(self, root: str, train: bool, transform: Callable):
        name = "train" if train else "test"
        path = os.path.join(root, "cifar-100-python", name)
        with open(path, "rb") as f:
            blob = pickle.load(f, encoding="latin1")
        self.images = blob["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = list(blob["fine_labels"])
        self.transform = transform

    def __len__(self) -> int:
        return len(self.labels)

    def load(self, index: int, rng: np.random.Generator):
        img = Image.fromarray(self.images[index])
        return self.transform(img, rng), self.labels[index]


class INatDataset(VisionDataset):
    """iNaturalist 2018/2019 with selectable label granularity.

    Reference: datasets.py:28-66 — reads ``train<year>.json`` /
    ``val<year>.json`` plus ``categories.json`` and maps images to the
    chosen taxonomic level (default ``name`` = species).
    """

    def __init__(self, root: str, train: bool, year: int, transform: Callable,
                 category: str = "name"):
        self.transform = transform
        split = "train" if train else "val"
        with open(os.path.join(root, f"{split}{year}.json")) as f:
            anno = json.load(f)
        with open(os.path.join(root, "categories.json")) as f:
            categories = json.load(f)

        values = sorted({str(c[category]) for c in categories})
        value_to_label = {v: i for i, v in enumerate(values)}
        self.num_classes = len(values)

        cat_to_label = {i: value_to_label[str(c[category])]
                        for i, c in enumerate(categories)}
        image_paths = {img["id"]: img["file_name"] for img in anno["images"]}
        self.samples = []
        for ann in anno["annotations"]:
            path = os.path.join(root, image_paths[ann["image_id"]])
            self.samples.append((path, cat_to_label[ann["category_id"]]))

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int, rng: np.random.Generator):
        path, label = self.samples[index]
        with Image.open(path) as img:
            return self.transform(img, rng), label


class SyntheticDataset(VisionDataset):
    """Deterministic class-separable images for tests and smoke training."""

    def __init__(self, num_classes: int = 8, size: int = 64, length: int = 256,
                 img_size: int = 224, transform: Optional[Callable] = None):
        self.num_classes = num_classes
        self.length = length
        self.size = size
        self.img_size = img_size
        self.transform = transform

    def __len__(self) -> int:
        return self.length

    def load(self, index: int, rng: np.random.Generator):
        label = index % self.num_classes
        g = np.random.default_rng(index)
        base = g.integers(0, 64, size=(self.size, self.size, 3), dtype=np.uint8)
        base = base + np.uint8(label * (192 // max(1, self.num_classes - 1)))
        img = Image.fromarray(base).resize((self.img_size, self.img_size))
        if self.transform is not None:
            return self.transform(img, rng), label
        return np.asarray(img, dtype=np.uint8), label


def build_dataset(is_train: bool, *, data_set: str, data_path: str,
                  transform: Callable, use_holdout: bool = False,
                  inat_category: str = "name") -> VisionDataset:
    """Reference ``build_dataset`` dispatch (datasets.py:71-101)."""
    data_set = data_set.upper()
    if data_set in ("CIFAR", "CIFAR100"):  # reference flag value is 'CIFAR'
        return CIFAR100Dataset(data_path, train=is_train, transform=transform)
    if data_set == "IMNET":
        if use_holdout:
            split = "sub-train" if is_train else "sub-val"
        else:
            split = "train" if is_train else "val"
        return ImageFolderDataset(os.path.join(data_path, split), transform)
    if data_set == "INAT":
        return INatDataset(data_path, train=is_train, year=2018,
                           transform=transform, category=inat_category)
    if data_set == "INAT19":
        return INatDataset(data_path, train=is_train, year=2019,
                           transform=transform, category=inat_category)
    if data_set.startswith("SYNTHETIC"):
        # SYNTHETIC[:num_classes[:length[:img_size]]]
        parts = data_set.split(":")[1:]
        kwargs = {}
        if parts:
            kwargs["num_classes"] = int(parts[0])
        if len(parts) > 1:
            kwargs["length"] = int(parts[1])
        if len(parts) > 2:
            kwargs["img_size"] = int(parts[2])
        return SyntheticDataset(transform=transform, **kwargs)
    raise ValueError(f"unknown dataset {data_set}")
