"""The port's phase spans (``utils.trace``): host operations of the
profiler's own trace while a session runs, one shared no-op context while
none runs, and the spans one train step, one keep-count draw and one
scoring chunk leave in the trace."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vit_search_torch.models import SupernetSchedules, VisionTransformerSR
from vit_search_torch.search import BatchedSupernetEvaluator
from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule, make_optimizer,
                                    make_train_step)
from vit_search_torch.utils import trace

# linear stem, two stages at 28 px, patch 7: N = 17 / 5
NET = ((0, 16),
       (1, (16, 2, 8), (16, 32), 1),
       (1, (16, 2, 8), (16, 32), 1),
       (3, 16, 32),
       (1, (32, 2, 16), (32, 64), 1),
       (2, 32, 10))
SPACE = [np.array([16, 12]),
         {"attn": np.array([16, 8]), "mlp": np.array([32, 16]), "layer": None},
         {"attn": np.array([16, 8]), "mlp": np.array([32, 16]), "layer": np.array([16, 0])},
         np.array([32, 24]),
         {"attn": np.array([32, 16]), "mlp": np.array([64, 32]), "layer": None},
         None]
IMG, PATCH, CLASSES, BATCH = 28, 7, 10, 4
TRAIN_PHASES = ["inputs", "masks", "mix", "forward", "backward", "allreduce", "update"]


def _spans(prof):
    """The ``vst.*`` events of a trace, in the order they began."""
    spans = [e for e in prof.events() if e.name.startswith("vst.")]
    return sorted(spans, key=lambda e: e.time_range.start)


def _model(token_mix: bool):
    return VisionTransformerSR(NET, img_size=IMG, patch_size=PATCH, num_classes=CLASSES,
                               patch_output=token_mix, device="cpu", seed=0)


def _images(rng, n):
    return torch.as_tensor(rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8))


def test_span_is_a_host_operation_of_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("vst.test.outer"):
            with trace.span("vst.test.inner"):
                torch.ones(3).sum()
    spans = _spans(prof)
    assert [e.name for e in spans] == ["vst.test.outer", "vst.test.inner"]
    for e in spans:
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation
        assert str(e.activity_type).endswith("cpu_op")
    outer, inner = (e.time_range for e in spans)
    assert outer.start <= inner.start and inner.end <= outer.end


def test_span_without_a_profiler_is_the_shared_no_op():
    first = trace.span("vst.test.off")
    assert first is trace.span("vst.test.other") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with first:                 # made before the session: records nothing
            torch.ones(3).sum()
    assert not _spans(prof)


@pytest.mark.parametrize("ema", [None, 0.9], ids=["no_ema", "ema"])
def test_train_step_spans(ema):
    model = _model(token_mix=True)
    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, steps_per_epoch=2,
                       clip_grad=1.0, global_batch_size=BATCH)
    cfg = TrainConfig(num_classes=CLASSES, mixup_mode="token", patch_len=2, ema_decay=ema,
                      erasing_prob=0.5)
    sched = SupernetSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    step = make_train_step(model, make_optimizer(ocfg, model), cfg, schedule=lr_schedule(ocfg),
                           counts_unpack=sched.unpack, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    images, labels = _images(rng, BATCH), torch.as_tensor(rng.integers(0, CLASSES, BATCH))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        counts = sched.sample_packed(rng, BATCH)
        step(images, labels, counts)
    spans = _spans(prof)
    phases = TRAIN_PHASES + (["ema"] if ema else [])
    assert [e.name for e in spans] == (["vst.supernet.sample", "vst.train.step"]
                                       + [f"vst.train.{p}" for p in phases])
    sample, outer = spans[0].time_range, spans[1].time_range
    assert sample.end <= outer.start
    children = [e.time_range for e in spans[2:]]
    for prev, cur in zip(children, children[1:]):
        assert prev.end <= cur.start
    assert outer.start <= children[0].start and children[-1].end <= outer.end


def test_score_chunk_spans():
    model = _model(token_mix=False)
    sched = SupernetSchedules(NET, SPACE, example_per_arch=1, num_warmup_epochs=0)
    rng = np.random.default_rng(1)
    loader = [(_images(rng, 3), rng.integers(0, CLASSES, 3)) for _ in range(3)]
    evaluator = BatchedSupernetEvaluator(model, sched, loader, arch_batch=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scores = evaluator.score([NET, NET])
    assert len(scores) == 2
    spans = _spans(prof)
    assert [e.name for e in spans] == (["vst.search.chunk", "vst.search.counts"]
                                       + ["vst.search.batch"] * len(loader)
                                       + ["vst.search.readback"])
    outer = spans[0].time_range
    assert all(outer.start <= e.time_range.start and e.time_range.end <= outer.end
               for e in spans[1:])
