"""The port's host data pipeline against the JAX package's, bit for bit.

The datasets, transforms, samplers, loaders and the holdout split of
``vit_search_torch.data`` are copies of ``vit_search_tpu.data`` (numpy and
PIL only): under one seed both packages must produce the same batches, on
the thread and the process worker backend. ``tests/test_data.py`` is the
pattern; the device feed is checked on the CPU here and on the card in
``tests/test_torch_gpu.py``.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import vit_search_tpu.data as jax_data
import vit_search_tpu.data.transforms as jax_transforms
import vit_search_tpu.tools.make_synthfolder as jax_synthfolder
import vit_search_torch.data as data
import vit_search_torch.data.transforms as transforms
import vit_search_torch.tools.make_synthfolder as synthfolder

SIZE = 24


def _make_imagefolder(root, classes=3, per_class=8, size=32):
    rng = np.random.default_rng(0)
    for c in range(classes):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img_{i}.jpg")
    return str(root)


def _make_cifar(root, n=24):
    d = root / "cifar-100-python"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    blob = {"data": rng.integers(0, 255, size=(n, 3 * 32 * 32), dtype=np.uint8),
            "fine_labels": list(rng.integers(0, 100, size=n))}
    with open(d / "train", "wb") as f:
        pickle.dump(blob, f)
    return str(root)


def _make_inat(root, n=24):
    rng = np.random.default_rng(0)
    images, annos = [], []
    (root / "imgs").mkdir(parents=True)
    for i in range(n):
        name = f"imgs/{i}.jpg"
        arr = rng.integers(0, 255, size=(20 + i % 5, 30, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / name)
        images.append({"id": i, "file_name": name})
        annos.append({"image_id": i, "category_id": i % 3})
    categories = [{"name": f"species_{c}", "genus": f"genus_{c % 2}"} for c in range(3)]
    with open(root / "train2018.json", "w") as f:
        json.dump({"images": images, "annotations": annos}, f)
    with open(root / "categories.json", "w") as f:
        json.dump(categories, f)
    return str(root)


DATASETS = {
    "imagefolder": lambda root: ("IMNET", _make_imagefolder(root / "train") and str(root)),
    "synthetic": lambda root: ("SYNTHETIC:4:24:40", ""),
    "cifar100": lambda root: ("CIFAR", _make_cifar(root)),
    "inat": lambda root: ("INAT", _make_inat(root)),
}


def _batches(pkg, data_set, data_path, backend, workers=2, epoch=3):
    ds = pkg.build_dataset(True, data_set=data_set, data_path=data_path,
                           transform=pkg.TrainTransform(size=SIZE))
    sampler = pkg.RepeatedAugmentSampler(len(ds), 1, 0, selected_round=0)
    loader = pkg.DataLoader(ds, sampler, 8, num_workers=workers, drop_last=True, seed=7,
                            worker_backend=backend)
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("backend", ["thread", "process"])
@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_loader_batches_match_jax(kind, backend, tmp_path):
    """Under one seed the port's train batches (RandomResizedCrop, flip,
    RandAugment rand-m9-mstd0.5-inc1) equal the JAX package's bit for bit."""
    data_set, data_path = DATASETS[kind](tmp_path)
    ours = _batches(data, data_set, data_path, backend)
    theirs = _batches(jax_data, data_set, data_path, backend)
    assert len(ours) == len(theirs) >= 2
    for (ia, la), (ib, lb) in zip(ours, theirs):
        assert ia.shape == (8, SIZE, SIZE, 3) and ia.dtype == np.uint8
        assert la.dtype == lb.dtype == np.int32
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


def test_loader_stream_is_independent_of_workers_and_backend(tmp_path):
    data_set, data_path = DATASETS["imagefolder"](tmp_path)
    one = _batches(data, data_set, data_path, "thread", workers=1)
    for backend, workers in (("thread", 4), ("process", 3)):
        for (ia, la), (ib, lb) in zip(one, _batches(data, data_set, data_path, backend,
                                                    workers)):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(la, lb)
    other_epoch = _batches(data, data_set, data_path, "thread", epoch=4)
    assert not np.array_equal(one[0][0], other_epoch[0][0])
    with pytest.raises(ValueError):
        data.DataLoader(None, [], 8, worker_backend="greenlet")


def _ra_ops(pkg):
    return pkg.RandAugment(mag_std=0.5).ops


@pytest.mark.parametrize("index", range(len(_ra_ops(transforms))))
def test_rand_augment_ops_match_jax(index):
    img = Image.fromarray(np.random.default_rng(1).integers(0, 255, (20, 24, 3), np.uint8))
    ours, theirs = _ra_ops(transforms)[index], _ra_ops(jax_transforms)[index]
    assert ours.__name__ == theirs.__name__
    for level in (0.0, 4.5, 9.0, 10.0):
        a = np.asarray(ours(img, level, np.random.default_rng(3)))
        b = np.asarray(theirs(img, level, np.random.default_rng(3)))
        np.testing.assert_array_equal(a, b, err_msg=f"{ours.__name__} at {level}")


@pytest.mark.parametrize("interpolation", ["bicubic", "bilinear", "random"])
def test_train_and_eval_transforms_match_jax(interpolation):
    img = Image.fromarray(np.random.default_rng(2).integers(0, 255, (48, 64, 3), np.uint8))
    for seed, spec in zip(range(6), ["rand-m9-mstd0.5-inc1", None] * 3):
        a = transforms.TrainTransform(size=SIZE, rand_augment=spec,
                                      interpolation=interpolation)(
            img, np.random.default_rng(seed))
        b = jax_transforms.TrainTransform(size=SIZE, rand_augment=spec,
                                          interpolation=interpolation)(
            img, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(transforms.EvalTransform(SIZE)(img),
                                  jax_transforms.EvalTransform(SIZE)(img))


@pytest.mark.parametrize("replicas", [1, 3])
def test_samplers_match_jax(replicas):
    for epoch in (0, 5):
        for rank in range(replicas):
            pairs = [(data.RepeatedAugmentSampler(103, replicas, rank, selected_round=16),
                      jax_data.RepeatedAugmentSampler(103, replicas, rank, selected_round=16)),
                     (data.ShardedSampler(103, replicas, rank),
                      jax_data.ShardedSampler(103, replicas, rank)),
                     (data.ShardedSampler(103, replicas, rank, shuffle=False),
                      jax_data.ShardedSampler(103, replicas, rank, shuffle=False))]
            for ours, theirs in pairs:
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                assert len(ours) == len(theirs)
                assert list(ours) == list(theirs)
            assert pairs[2][0].num_valid_samples == pairs[2][1].num_valid_samples
    with pytest.raises(ValueError):
        data.ShardedSampler(10, 2, 2)
    with pytest.raises(ValueError):
        _ = data.ShardedSampler(10, 2, 0).num_valid_samples


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_padded_eval_loader_matches_jax(backend, tmp_path):
    root = _make_imagefolder(tmp_path / "val", classes=3, per_class=7)
    outs = []
    for pkg in (data, jax_data):
        ds = pkg.ImageFolderDataset(root, pkg.EvalTransform(SIZE))
        shards = []
        for rank in range(2):
            sampler = pkg.ShardedSampler(len(ds), 2, rank, shuffle=False)
            loader = pkg.PaddedEvalLoader(
                pkg.DataLoader(ds, sampler, 4, num_workers=2, drop_last=False,
                               worker_backend=backend), sampler.num_valid_samples)
            shards.append(list(loader))
        outs.append(shards)
    for shard_a, shard_b in zip(*outs):
        assert len(shard_a) == len(shard_b) == 3
        for a, b in zip(shard_a, shard_b):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # every image is counted once over the shards; padding rows weigh 0
    assert sum(float(v.sum()) for shard in outs[0] for _, _, v in shard) == 21.0
    with pytest.raises(ValueError):
        data.PaddedEvalLoader(data.DataLoader(None, [], 4, drop_last=True), 0)


def test_holdout_split_matches_jax(tmp_path):
    for name in ("ours", "theirs"):
        _make_imagefolder(tmp_path / name / "train", classes=3, per_class=6)
    assert (data.select_holdout(str(tmp_path / "ours" / "train"), per_class=2, seed=4)
            == jax_data.select_holdout(str(tmp_path / "theirs" / "train"), per_class=2,
                                       seed=4))
    data.build_subsets(str(tmp_path / "ours"), per_class=2, seed=1)
    jax_data.build_subsets(str(tmp_path / "theirs"), per_class=2, seed=1)
    for split in ("sub-train", "sub-val"):
        for cls in sorted(os.listdir(tmp_path / "ours" / split)):
            assert (sorted(os.listdir(tmp_path / "ours" / split / cls))
                    == sorted(os.listdir(tmp_path / "theirs" / split / cls)))
    with open(tmp_path / "ours" / "sub_val_files.json") as f:
        ours = json.load(f)
    with open(tmp_path / "theirs" / "sub_val_files.json") as f:
        assert ours == json.load(f)
    sub_val = data.build_dataset(False, data_set="IMNET", data_path=str(tmp_path / "ours"),
                                 transform=data.EvalTransform(16), use_holdout=True)
    sub_train = data.build_dataset(True, data_set="IMNET", data_path=str(tmp_path / "ours"),
                                   transform=data.EvalTransform(16), use_holdout=True)
    assert len(sub_val) == 6 and len(sub_train) == 12
    assert not ({p for p, _ in sub_train.samples} & {p for p, _ in sub_val.samples})
    with pytest.raises(ValueError):
        data.select_holdout(str(tmp_path / "ours" / "train"), per_class=7)


def test_reference_holdout_pickle_import(tmp_path):
    """The reference's pinned ``sub_val_files.pickle`` wins over a seeded
    split, with the reference's validation, as in the JAX package."""
    root = tmp_path
    _make_imagefolder(root / "train")
    classes = sorted(d.name for d in os.scandir(root / "train"))
    pinned = {cls: [sorted(os.listdir(root / "train" / cls))[0]] for cls in classes}
    pkl = root / "sub_val_files.pickle"
    with open(pkl, "wb") as f:
        pickle.dump(pinned, f)

    manifest = data.build_subsets(str(root))  # finds the pickle beside the data
    with open(manifest) as f:
        assert json.load(f) == pinned
    with pytest.raises(ValueError):
        data.convert_reference_pickle(str(pkl), expect_classes=1000)
    with pytest.raises(ValueError):
        data.convert_reference_pickle(str(pkl), expect_per_class=25)
    assert (data.convert_reference_pickle(str(pkl), expect_classes=3, expect_per_class=1)
            == jax_data.convert_reference_pickle(str(pkl)) == pinned)

    out = root / "converted.json"
    subprocess.run([sys.executable, "-m", "vit_search_torch.data.subset", str(root),
                    "--convert-only", "--reference-pickle", str(pkl), "--manifest", str(out)],
                   check=True, capture_output=True, cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
    with open(out) as f:
        assert json.load(f) == pinned


def test_make_synthfolder_matches_jax(tmp_path):
    synthfolder.generate(str(tmp_path / "ours"), num_classes=3, train_per_class=2,
                         val_per_class=1, size=32, seed=2, workers=2)
    jax_synthfolder.generate(str(tmp_path / "theirs"), num_classes=3, train_per_class=2,
                             val_per_class=1, size=32, seed=2)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ours")
                   for d, _, fs in os.walk(tmp_path / "ours") for f in fs)
    assert len(files) == 9
    for rel in files:
        assert ((tmp_path / "ours" / rel).read_bytes()
                == (tmp_path / "theirs" / rel).read_bytes()), rel


def test_device_feed_on_the_cpu_hands_out_the_loader_batches(tmp_path):
    data_set, data_path = DATASETS["synthetic"](tmp_path)
    batches = _batches(data, data_set, data_path, "thread")
    fed = list(data.prefetch_to_device(iter(batches), "cpu"))
    assert len(fed) == len(batches)
    for (images, labels), (ia, la) in zip(fed, batches):
        assert images.dtype == torch.uint8 and labels.dtype == torch.int64
        np.testing.assert_array_equal(images.numpy(), ia)
        np.testing.assert_array_equal(labels.numpy(), la)


class _RaisingDataset(data.SyntheticDataset):
    def load(self, index, rng):
        if index == 5:
            raise OSError("simulated corrupt image at index 5")
        return super().load(index, rng)


class _DyingDataset(data.SyntheticDataset):
    def load(self, index, rng):
        if index == 5:
            os._exit(3)
        return super().load(index, rng)


@pytest.mark.parametrize("dataset, backend, match", [
    (_RaisingDataset, "thread", "worker failed"),
    (_RaisingDataset, "process", "worker failed"),
    (_DyingDataset, "process", "died with exit code|never arrived"),
])
def test_loader_worker_failures_are_loud(dataset, backend, match):
    ds = dataset(num_classes=4, size=8, length=16, img_size=8,
                 transform=data.EvalTransform(size=8))
    loader = data.DataLoader(ds, data.ShardedSampler(len(ds), 1, 0, shuffle=False), 4,
                             num_workers=2, drop_last=True, worker_backend=backend)
    with pytest.raises(RuntimeError, match=match):
        list(loader)


def test_process_workers_die_on_sigterm_under_a_parent_handler(tmp_path):
    """A SIGTERM handler in the parent (the CLI's preemption flag) does not
    keep forked workers alive: the loader ends them promptly."""
    import signal
    import time

    previous = signal.signal(signal.SIGTERM, lambda *_: None)
    try:
        ds = data.SyntheticDataset(num_classes=4, length=64, img_size=8)
        loader = data.DataLoader(ds, data.ShardedSampler(len(ds), 1, 0), 4, num_workers=2,
                                 worker_backend="process")
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)
        it.close()   # terminates the workers and joins them
        assert time.perf_counter() - t0 < 4.0
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_loader_check_runs_on_the_cpu(capsys):
    from vit_search_torch.tools import loader_check

    out = loader_check.main(["--classes", "2", "--per-class", "2", "--batch", "2",
                             "--workers", "1,2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    assert out["transform_ms"] > 0 and set(out["python_scaling"]) == {1, 2}
    assert sorted(out["loader_imgs_per_s"]) == ["process 1", "process 2", "thread 1",
                                                "thread 2"]
