"""The CLI epoch cell (``benchmark/drivers/cli_epoch.py``) on the CPU at a
small size: the published script through the port's training CLI on a
folder of 30 JPEGs, the harness's small supernet at 112 px and 8 images a
step; its first step is held to the float32 reference under the cell's own
limits, every step of the window takes the loader's next batch, and the
CLI stops after the window."""

import copy
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for _path in (BENCH, os.path.join(BENCH, "tests")):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import tiny  # noqa: E402
from benchlib import harness, shapes  # noqa: E402

CELL = "tiny_supernet.cli_epoch"
CLASSES = 10


@pytest.fixture
def small_space():
    """The harness's small search space in the port's registry for the
    test alone (the port's spaces are otherwise the JAX package's)."""
    from vit_search_torch.arch import spaces

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    tiny.register_space()
    yield
    spaces._SPACES.pop(tiny.SPACE_NAME, None)
    torch.set_num_threads(before)


def bench_with_cell(root):
    """A copy of ``BENCHMARK.json`` in ``root`` that holds the cell, which
    reports ``train_imgs_per_s`` as the other train cells do."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": CELL, "config": "vit_resnas_tiny_supernet",
                               "traffic": "supernet_cli_epoch", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_imgs_per_s":
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def small_run(seed, root):
    bench_with_cell(root)
    mix = copy.deepcopy(tiny.load("mixes", "supernet_cli_epoch.json"))
    net = tiny.NETWORK_DEF[:-1] + [[2, 64, CLASSES]]
    cfg = tiny.config()
    cfg.update(network_def=net, num_classes=CLASSES)
    mix.update(folder={"classes": CLASSES, "train": 4, "holdout": 1, "size": 64, "workers": 1},
               window_steps=2,
               cli_flags={"--network-def": repr(shapes.to_tuple(net)),
                          "--search-space": tiny.SPACE_NAME, "--batch-size": "8",
                          "--input-size": "112", "--mixup-patch-len": "2",
                          "--example-per-arch": "2"})
    return harness.make_run(root, CELL, seed, 0.0, False, "cpu", time.perf_counter(),
                            config=cfg, mix=mix)


def test_the_script_through_the_cli_is_correct_on_the_cpu(small_space, tmp_path):
    result = harness.execute(small_run(2**31 + 7, str(tmp_path)))
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert result["checks"]["unread_batches"]["value"] == 0
    assert list(result["metrics"]) == ["train_imgs_per_s", "peak_mem_gib", "setup_s"]
    assert not os.listdir(os.path.join(ROOT, ".bench_cache")) or not any(
        n.startswith(f"cli_epoch_{os.getpid()}") for n in os.listdir(os.path.join(ROOT, ".bench_cache")))
