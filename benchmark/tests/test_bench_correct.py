"""``correct`` at a size a test run holds, on the CPU, under each cell's
own limits: a sound run passes; the control (the reference in the
program's place, computed in the cell's control precision: float8 operands
for a train cell, int8 for the search) fails; and a run whose
timed path is broken underneath fails, once for each fault the cell can
have: a step that returns its state unchanged, half of the batch left out
with the mean taken over the rest, an answer altered where it is produced.
(One card: no exchange between chips to leave out.)"""

import time

import pytest

import tiny

ROOT = tiny.ROOT


def train_run(seed, limits_of="tiny_supernet.train"):
    from benchlib import harness

    tiny.register_space()
    return harness.make_run(ROOT, limits_of, seed, 0.2, False, "cpu", time.perf_counter(),
                            config=tiny.config(), mix=tiny.mix())


def search_run(seed):
    from benchlib import harness

    tiny.register_space()
    mix = tiny.search_mix()
    mix["sub_val_images"] = 400
    return harness.make_run(ROOT, "tiny_supernet.search", seed, 0.2, False, "cpu",
                            time.perf_counter(), config=tiny.config(), mix=mix)


def execute(run):
    from benchlib import harness

    return harness.execute(run)


@pytest.mark.parametrize("seed", [1, 2])
def test_sound_train_run_is_correct(seed):
    result = execute(train_run(seed))
    assert result["correct"], result["checks"]
    assert list(result["metrics"]) == ["train_imgs_per_s", "peak_mem_gib", "setup_s"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("seed", [1, 2])
def test_control_is_not_correct(seed):
    """The reference in the program's place in the cell's control precision
    (float8 operands) fails the cell's limits."""
    import calibrate
    from benchlib import compare

    run = train_run(seed)
    ok, checks = compare.judge(calibrate.readings(run, run.limits["control"]),
                               run.limits["limits"])
    assert not ok, checks


def test_frozen_state_is_not_correct(monkeypatch):
    import torch
    from vit_search_torch.train import engine

    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    monkeypatch.setattr(engine, "ema_update", lambda *args, **kwargs: None)
    result = execute(train_run(3))
    assert not result["correct"]
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct(monkeypatch):
    from vit_search_torch.train import losses

    real = losses.soft_target_cross_entropy

    def half(logits, targets):
        rows = logits.shape[0] // 2
        return real(logits[:rows], targets[:rows])

    monkeypatch.setattr(losses, "soft_target_cross_entropy", half)
    result = execute(train_run(4))
    assert not result["correct"], result["checks"]


def test_sound_search_run_is_correct():
    result = execute(search_run(1))
    assert result["correct"], result["checks"]
    assert list(result["metrics"]) == ["search_cand_imgs_per_s", "peak_mem_gib", "setup_s"]


def test_altered_answer_is_not_correct(monkeypatch):
    from vit_search_torch.search import batched_eval

    real = batched_eval.BatchedSupernetEvaluator.score

    def altered(self, defs, progress=None):
        return [s - 5.0 for s in real(self, defs, progress)]

    monkeypatch.setattr(batched_eval.BatchedSupernetEvaluator, "score", altered)
    result = execute(search_run(1))
    assert not result["correct"], result["checks"]


def test_search_control_is_not_correct():
    import calibrate
    from benchlib import compare

    run = search_run(2)
    limit = {"logit_error": run.limits["limits"]["logit_error"]}
    ok, checks = compare.judge(calibrate.search_readings(run, run.limits["control"]), limit)
    assert not ok, checks
