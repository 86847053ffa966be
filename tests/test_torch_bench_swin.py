"""The SwinV2 train cell (``benchmark/drivers/swin_train.py``) on the CPU at
a small size: a sound run in float32 is ``correct`` under the cell's own
limits, the float8 control and the half-batch fault are not; and the
cell's cost model (the published 21.8 G), call table and shift regions,
written independently of the port, agree with the port's."""

import copy
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from benchlib import compare, harness, swin  # noqa: E402


CELL = "swinv2_base.train"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small models run no faster on more, and
    beside the suite's other workers more threads only contend (a full
    tier-1 run read this file up to 40x slower on the default count)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def small_run(seed, bf16=False):
    """The cell at 64 px, embed 32, window 4, heads 1 / 2 / 4 / 8, depths
    2 / 2 / 2 / 2, 10 classes, 8 images in chunks of 4."""
    cfg = copy.deepcopy(load("configs", "swinv2_base_w16_256.json"))
    cfg.update(img_size=64, embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8],
               window_size=4, num_classes=10)
    mix = copy.deepcopy(load("mixes", "swinv2_train.json"))
    mix["flags"].update(batch_size=8, input_size=64, bf16=bf16)
    mix["reference_chunk"] = 4
    return harness.make_run(ROOT, CELL, seed, 0.2, False, "cpu", time.perf_counter(),
                            config=cfg, mix=mix)


@pytest.mark.parametrize("seed", [1, 2])
def test_sound_float32_run_is_correct(seed):
    result = harness.execute(small_run(seed))
    assert result["correct"], result["checks"]
    assert list(result["metrics"]) == ["train_imgs_per_s", "peak_mem_gib", "setup_s"]


@pytest.mark.parametrize("side", ["fp8", "half_batch"])
def test_control_and_fault_are_not_correct(side):
    sys.path.insert(0, BENCH)
    import calibrate_swin

    run = small_run(3)
    ok, checks = compare.judge(calibrate_swin.readings(run, side), run.limits["limits"])
    assert not ok, checks


def test_cost_calls_and_regions_agree_with_the_port():
    cfg = load("configs", "swinv2_base_w16_256.json")
    # Swin's flops() at 256 px, window 16: the published 21.8 G
    assert swin.macs(cfg) == cfg["macs_per_image"]["256"] == pytest.approx(21.8e9, rel=0.005)
    calls = swin.window_calls(cfg, 256)
    assert sum(count for _, count in calls) == sum(cfg["depths"])
    assert dict(calls) == {(4096, 256, 4, 0): 1, (4096, 256, 4, 8): 1, (1024, 256, 8, 0): 1,
                           (1024, 256, 8, 8): 1, (256, 256, 16, 0): 18, (256, 64, 32, 0): 2}
