"""A train step restored from a checkpoint draws what an uninterrupted one
draws: every call derives its host and device generators from ``(seed,
state.step)``, the port's counterpart of the JAX step's ``fold_in(rng,
state.step)`` (vit_search_tpu/train/engine.py:95). Random erasing, token
mixup or timm Mixup/CutMix, drop-path and dropout are all on, nothing is
injected, and the comparison is bit for bit on the CPU.
"""

import numpy as np
import pytest
import torch

from vit_search_torch.models import SupernetSchedules, VisionTransformerSR
from vit_search_torch.train import (CheckpointManager, OptimConfig, TrainConfig,
                                    lr_schedule, make_optimizer, make_train_step)
from vit_search_torch.train.engine import step_generators

from test_torch_model import NET, SPACE

IMG, CLASSES, BATCH, STEPS, SAVED_AT = 56, 10, 4, 5, 2


def _step(mode, init_seed=0, run_seed=0):
    model = VisionTransformerSR(NET, img_size=IMG, patch_size=14, num_classes=CLASSES,
                                patch_output=mode == "token", drop_path_rate=0.2,
                                dropout_rate=0.1, device="cpu", seed=init_seed)
    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, steps_per_epoch=2,
                       clip_grad=1.0, global_batch_size=BATCH)
    cfg = TrainConfig(num_classes=CLASSES, mixup_mode=mode, patch_len=2, ema_decay=0.9,
                      erasing_prob=0.5, erasing_count=2, mixup_elem_mode="elem")
    sched = SupernetSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    return make_train_step(model, make_optimizer(ocfg, model), cfg, schedule=lr_schedule(ocfg),
                           counts_unpack=sched.unpack, seed=run_seed, device="cpu"), sched


def _inputs(sched, i):
    rng = np.random.default_rng(100 + i)
    images = torch.as_tensor(rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8))
    labels = torch.as_tensor(rng.integers(0, CLASSES, BATCH))
    return images, labels, sched.sample_packed(rng, BATCH)


def _run(step, sched, steps):
    return [float(step(*_inputs(sched, i))["loss"]) for i in steps]


def _state(step):
    sd = step.state_dict()
    return {**{f"p.{k}": v for k, v in sd["params"].items()},
            **{f"b.{k}": v for k, v in sd["batch_stats"].items()},
            **{f"e.{k}": v for k, v in sd["ema_params"].items()}}


@pytest.mark.parametrize("mode", ["token", "mixup"])
def test_restored_step_replays_the_uninterrupted_run(mode, tmp_path):
    whole, sched = _step(mode)
    losses = _run(whole, sched, range(STEPS))

    first, sched = _step(mode)
    assert _run(first, sched, range(SAVED_AT)) == losses[:SAVED_AT]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("mid", first, {})

    # another initialization, the same run seed: everything else comes back
    # from the checkpoint
    resumed, sched = _step(mode, init_seed=1)
    mgr.restore("mid", resumed)
    assert resumed.state.step == SAVED_AT
    assert _run(resumed, sched, range(SAVED_AT, STEPS)) == losses[SAVED_AT:]
    ours, theirs = _state(resumed), _state(whole)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


def test_draws_depend_on_the_seed_and_the_step_only():
    host_a, dev_a = step_generators(3, 7, torch.device("cpu"))
    host_b, dev_b = step_generators(3, 7, torch.device("cpu"))
    assert host_a.random() == host_b.random()
    assert torch.equal(torch.rand(4, generator=dev_a), torch.rand(4, generator=dev_b))
    for seed, step in ((3, 8), (4, 7)):
        host_c, dev_c = step_generators(seed, step, torch.device("cpu"))
        assert host_c.random() != np.random.default_rng((3, 7)).random()
        assert not torch.equal(torch.rand(4, generator=dev_c),
                               torch.rand(4, generator=step_generators(3, 7, "cpu")[1]))


def test_steps_draw_anew_and_the_run_seed_matters():
    """Two steps from the same state and inputs draw differently when their
    step counters differ, and so do two runs of other seeds: the draws are
    not replayed from step 0."""
    a, sched = _step("token")
    b, _ = _step("token")
    b.load_state_dict(a.state_dict())
    b.state.step = 3
    images, labels, counts = _inputs(sched, 0)
    assert float(a(images, labels, counts)["loss"]) != float(b(images, labels, counts)["loss"])
    c, _ = _step("token", run_seed=1)
    d, _ = _step("token")
    assert float(c(images, labels, counts)["loss"]) != float(d(images, labels, counts)["loss"])
