"""The EVA-02 fine-tune cell (``benchmark/drivers/eva_train.py``) on the CPU
at a small size: a sound run in float32 is ``correct`` under the cell's own
limits, the float8 control and the three planted faults are not; and the
cell's cost model and parameter count, written from the published
configuration, agree with the configuration file and with the port's
model."""

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

from benchlib import compare, eva, harness  # noqa: E402

CELL = "eva02_large.ft448"
SMALL = dict(img_size=56, embed_dim=64, depth=2, num_heads=2, num_classes=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def small_run(seed):
    """The cell at 56 px, C 64, 2 heads, depth 2, 10 classes, 8 images in
    chunks of 4, in float32."""
    cfg = copy.deepcopy(load("configs", "eva02_large_p14_448.json"))
    cfg.update(SMALL)
    mix = copy.deepcopy(load("mixes", "eva02_ft448.json"))
    mix["flags"].update(batch_size=8, input_size=56, bf16=False)
    mix["reference_chunk"] = 4
    return harness.make_run(ROOT, CELL, seed, 0.2, False, "cpu", time.perf_counter(),
                            config=cfg, mix=mix)


def test_sound_float32_run_is_correct():
    result = harness.execute(small_run(1))
    assert result["correct"], result["checks"]
    assert list(result["metrics"]) == ["train_imgs_per_s", "peak_mem_gib", "setup_s"]


@pytest.mark.parametrize("side", ["fp8", "half_batch", "rope_off", "ffn_ln_off"])
def test_control_and_faults_are_not_correct(side):
    import calibrate_eva

    run = small_run(3)
    ok, checks = compare.judge(calibrate_eva.readings(run, side), run.limits["limits"])
    assert not ok, checks


def test_cost_and_parameters_agree_with_the_configuration_and_the_port():
    from vit_search_torch import models

    cfg = load("configs", "eva02_large_p14_448.json")
    assert eva.macs(cfg) == cfg["macs_per_image"]["448"] == pytest.approx(361.7e9, rel=1e-3)
    assert eva.parameters(cfg) == cfg["parameters"] == pytest.approx(305.1e6, rel=1e-3)
    assert eva.rope_shape(cfg, 48) == (48, 1025, 16, 64)
    small = dict(cfg, **SMALL)
    model = models.create_model(cfg["model"], device="cpu", **SMALL)
    assert eva.parameters(small) == sum(p.numel() for p in model.parameters())
    # the SwiGLU sub-LN is measured at the pitch the model runs (2730 padded to 2736)
    pad = models.create_model(cfg["model"], device="cpu", **dict(SMALL, embed_dim=1024,
                                                                   num_heads=16, depth=1)
                              ).blocks[0].mlp.pad
    assert eva.swiglu_shape(cfg, 48, pad) == (48 * 1025, 2730, 2736)


def test_the_kernel_table_counts_the_work_the_benchmark_counts():
    """``chip_smoke.py``'s bounds of R1/R2 and G1/G2 use the benchmark's
    counts of their work (``benchlib/eva.py``)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    for b, n, h, d in ((48, 1025, 16, 64), (4, 1025, 16, 64), (2, 17, 2, 32)):
        for backward in (False, True):
            assert chip_smoke.eva_attention_work(b, n, h, d, backward) == (
                eva.rope_bytes(b, n, h, d, backward), eva.rope_flops(b, n, h, d, backward))
    for rows, hidden in ((48 * 1025, 2730), (8, 170)):
        for backward in (False, True):
            assert chip_smoke.eva_swiglu_bytes(rows, hidden, backward) == eva.swiglu_bytes(
                rows, hidden, backward)
