"""Sub-train / sub-val holdout split.

A copy of vit_search_tpu/data/subset.py: the same seed picks the same files.

Reproduces the capability of the reference subset script
(search_utils/build_subset.py): split the ImageNet train set into
``sub-train`` (supernet training) and ``sub-val`` (search fitness), holding
out a fixed number of images per class.  The reference pins its holdout in
a shipped pickle (``search_utils/sub_val_files.pickle``, a dict
``{wnid: [25 JPEG names]}`` consumed by search_utils/build_subset.py:20-58);
``convert_reference_pickle`` imports that exact split into the JSON
manifest this module consumes, and ``build_subsets`` prefers a reference
pickle (given explicitly or found next to the data) over generating a
fresh seeded split — so search fitness numbers are comparable against
reference supernet checkpoints.

Files are hard-linked when possible (falls back to copying), so the split
costs no extra disk for the common single-filesystem case.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

DEFAULT_HOLDOUT_PER_CLASS = 25  # reference: 25 images/class x 1000 classes


def select_holdout(train_dir: str, per_class: int = DEFAULT_HOLDOUT_PER_CLASS,
                   seed: int = 0) -> Dict[str, List[str]]:
    """Deterministically pick ``per_class`` holdout file names per class."""
    rng = np.random.default_rng(seed)
    holdout: Dict[str, List[str]] = {}
    for cls in sorted(d.name for d in os.scandir(train_dir) if d.is_dir()):
        files = sorted(e.name for e in os.scandir(os.path.join(train_dir, cls))
                       if e.is_file())
        if len(files) < per_class:
            raise ValueError(f"class {cls} has only {len(files)} images")
        pick = rng.choice(len(files), size=per_class, replace=False)
        holdout[cls] = sorted(files[i] for i in pick)
    return holdout


def convert_reference_pickle(pickle_path: str,
                             manifest_path: Optional[str] = None,
                             expect_classes: Optional[int] = None,
                             expect_per_class: Optional[int] = None
                             ) -> Dict[str, List[str]]:
    """Import the reference's pinned holdout pickle into a JSON manifest.

    The pickle is ``{class_dir: [file names]}`` exactly as produced by
    reference search_utils/build_subset.py:28-57 (1000 ImageNet wnids x 25
    JPEGs for the shipped artifact).  Pass ``expect_classes`` /
    ``expect_per_class`` to enforce the reference's own validation
    (build_subset.py:64-70).  Returns the holdout dict; writes
    ``manifest_path`` when given.
    """
    import pickle

    with open(pickle_path, "rb") as f:
        raw = pickle.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{pickle_path}: expected dict, got {type(raw)}")
    holdout = {str(cls): sorted(str(n) for n in names)
               for cls, names in raw.items()}
    if expect_classes is not None and len(holdout) != expect_classes:
        raise ValueError(f"expected {expect_classes} classes, "
                         f"got {len(holdout)}")
    if expect_per_class is not None:
        for cls, names in holdout.items():
            if len(names) != expect_per_class:
                raise ValueError(f"class {cls}: expected {expect_per_class} "
                                 f"holdout images, got {len(names)}")
    if manifest_path:
        with open(manifest_path, "w") as f:
            json.dump(holdout, f)
    return holdout


def _find_reference_pickle(data_path: str) -> Optional[str]:
    for name in ("sub_val_files.pickle", "sub_val_files.pkl"):
        p = os.path.join(data_path, name)
        if os.path.exists(p):
            return p
    return None


def _place(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def build_subsets(data_path: str, per_class: int = DEFAULT_HOLDOUT_PER_CLASS,
                  seed: int = 0, manifest_path: Optional[str] = None,
                  reference_pickle: Optional[str] = None) -> str:
    """Materialize ``sub-train``/``sub-val`` under ``data_path``.

    Returns the manifest path.  Precedence: existing manifest > reference
    pickle (explicit or ``sub_val_files.pickle`` beside the data) > fresh
    seeded selection — so splits are stable across machines and match the
    reference's pinned holdout whenever it is available.
    """
    train_dir = os.path.join(data_path, "train")
    manifest_path = manifest_path or os.path.join(data_path, "sub_val_files.json")

    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            holdout = json.load(f)
    else:
        reference_pickle = reference_pickle or _find_reference_pickle(data_path)
        if reference_pickle:
            holdout = convert_reference_pickle(reference_pickle, manifest_path)
        else:
            holdout = select_holdout(train_dir, per_class=per_class, seed=seed)
            with open(manifest_path, "w") as f:
                json.dump(holdout, f)

    sub_train = os.path.join(data_path, "sub-train")
    sub_val = os.path.join(data_path, "sub-val")
    for cls, held in holdout.items():
        held_set = set(held)
        src_dir = os.path.join(train_dir, cls)
        train_dst = os.path.join(sub_train, cls)
        val_dst = os.path.join(sub_val, cls)
        os.makedirs(train_dst, exist_ok=True)
        os.makedirs(val_dst, exist_ok=True)
        for entry in os.scandir(src_dir):
            if not entry.is_file():
                continue
            dst = val_dst if entry.name in held_set else train_dst
            target = os.path.join(dst, entry.name)
            if not os.path.exists(target):
                _place(entry.path, target)
    return manifest_path


def _main() -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Build sub-train/sub-val splits, or import the "
                    "reference sub_val_files.pickle into a JSON manifest.")
    p.add_argument("data_path", help="dataset root containing train/")
    p.add_argument("--per-class", type=int, default=DEFAULT_HOLDOUT_PER_CLASS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--manifest", default=None)
    p.add_argument("--reference-pickle", default=None,
                   help="path to the reference sub_val_files.pickle; "
                        "auto-detected beside the data when omitted")
    p.add_argument("--convert-only", action="store_true",
                   help="only write the manifest from --reference-pickle, "
                        "do not materialize the splits")
    args = p.parse_args()
    if args.convert_only:
        if not args.reference_pickle:
            p.error("--convert-only requires --reference-pickle")
        manifest = args.manifest or os.path.join(args.data_path,
                                                 "sub_val_files.json")
        convert_reference_pickle(args.reference_pickle, manifest)
        print(manifest)
        return
    print(build_subsets(args.data_path, per_class=args.per_class,
                        seed=args.seed, manifest_path=args.manifest,
                        reference_pickle=args.reference_pickle))


if __name__ == "__main__":
    _main()
