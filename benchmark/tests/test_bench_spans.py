"""The split of a trace's idle time by the program's phase spans
(``benchlib/spans.py``) on hand-made events."""

import pytest


def _event(name, start, end, cuda=False, thread=1, note=False):
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    return FunctionEvent(0, name, thread, start, end, is_user_annotation=note,
                         device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def _trace():
    """Two steps: the device idles 0-10 (sample, then inputs), 30-50 (inputs
    until forward begins, then forward), 60-70 (outside every span) and
    120-125 (ema); a sync starts in each step, one outside."""
    e = _event
    return [
        e("bench.sample_counts", 0, 5), e("vst.supernet.sample", 1, 4),
        e("bench.train_step", 5, 60), e("vst.train.step", 5, 60),
        e("vst.train.inputs", 6, 20), e("vst.train.forward", 40, 58),
        e("bench.train_step", 70, 130), e("vst.train.step", 70, 130),
        e("vst.train.ema", 110, 128),
        e("vst.train.forward", 5, 60, thread=2),        # another thread: not the host's
        e("cudaStreamSynchronize", 45, 46), e("cudaStreamSynchronize", 100, 101),
        e("cudaStreamSynchronize", 65, 66),
        e("k1", 10, 30, cuda=True), e("k2", 50, 60, cuda=True), e("Memcpy HtoD", 70, 80, cuda=True),
        e("k3", 80, 120, cuda=True), e("Optimizer.step", 125, 126, cuda=True, note=True),
        e("k4", 126, 140, cuda=True),
        e("bench.train_step", 5, 60, cuda=True, note=True),   # the span's device mirror
    ]


def test_idle_split_by_innermost_span():
    from benchlib import device, spans

    events = _trace()
    out = spans.reduce(events, ("bench.sample_counts", "bench.train_step"))
    us = 1e-6
    assert out["window_s"] == pytest.approx(140 * us)
    idle = out["idle_s"]
    # 0-1 outside, 1-4 sample, 4-5 outside, 5-6 the step before its first
    # phase, 6-10 inputs; 30-40 inputs (until the next phase), 40-50 forward;
    # 60-70 outside; 120-125 ema
    assert idle == pytest.approx({"outside": 12 * us, "vst.supernet.sample": 3 * us,
                                  "vst.train.step": 1 * us, "vst.train.inputs": 14 * us,
                                  "vst.train.forward": 10 * us, "vst.train.ema": 5 * us})
    whole = device.reduce_trace(events, ("bench.sample_counts", "bench.train_step"))
    assert sum(idle.values()) == pytest.approx(whole["window_s"] - whole["busy_s"])
    assert out["count"] == {"vst.supernet.sample": 1, "vst.train.step": 2,
                            "vst.train.inputs": 1, "vst.train.forward": 1, "vst.train.ema": 1}
    assert out["syncs"]["vst.train.step"] == 2 and out["syncs"]["vst.train.forward"] == 1
    assert out["syncs"]["vst.train.ema"] == 0
    # kernels: not copies, nor annotations mirrored on the device
    assert out["kernels"] == 4


def test_a_gap_across_two_phases_is_split():
    """Idle 0-50: counts until batch begins at 30, then batch."""
    from benchlib import spans

    e = _event
    events = [e("bench.score_chunk", 0, 100), e("vst.search.chunk", 0, 100),
              e("vst.search.counts", 0, 25), e("vst.search.batch", 30, 60),
              e("k", 50, 100, cuda=True)]
    out = spans.reduce(events, ("bench.score_chunk",))
    assert out["idle_s"] == pytest.approx({"vst.search.counts": 30e-6,
                                           "vst.search.batch": 20e-6})


def test_a_program_without_spans_is_all_outside():
    from benchlib import device, spans

    events = [ev for ev in _trace() if not ev.name.startswith("vst.")]
    out = spans.reduce(events, ("bench.sample_counts", "bench.train_step"))
    whole = device.reduce_trace(events, ("bench.sample_counts", "bench.train_step"))
    assert list(out["idle_s"]) == ["outside"]
    assert out["idle_s"]["outside"] == pytest.approx(whole["window_s"] - whole["busy_s"])
    assert out["count"] == {} and out["syncs"] == {}
    assert spans.reduce([e for e in events if e.device_type.name == "CPU"],
                        ("bench.train_step",)) == {}
