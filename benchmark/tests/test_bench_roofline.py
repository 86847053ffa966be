"""Operations and bytes of the kernels' work on hand-worked shapes; where
a network's attention and masked layer norms run."""

import json
import os

import pytest

from conftest import BENCH


def test_attention_counts():
    from benchlib import device

    # B 2, N 3, H 1, D 4: q k^T and p v are 2 * 3 * 3 * 4 = 72 multiply-adds each
    assert device.attention_fwd_flops(2, 3, 1, 4) == 2 * 2 * 72
    assert device.attention_bwd_flops(2, 3, 1, 4) == 5 * 2 * 72
    # packed (2, 3, 12) bf16 in, (2, 3, 4) out; the backward adds g in, dqkv out
    assert device.attention_bytes(2, 3, 1, 4, False) == 2 * (72 + 24)
    assert device.attention_bytes(2, 3, 1, 4, True) == 2 * (72 + 24 + 72)


def test_masked_ln_bytes():
    from benchlib import device

    # B 2, N 3, C 4: x 24 bf16 values, mask 8, float32 weight and bias 4 each
    assert device.masked_ln_bytes(2, 3, 4, False) == 48 + 16 + 32 + 48
    assert device.masked_ln_bytes(2, 3, 4, True) == 48 + 16 + 16 + 48 + 48 + 32


def test_bound_takes_the_slower_roof():
    from benchlib import device

    assert device.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert device.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert device.share_pct(1.0, 4.0) == 25.0
    with pytest.raises(ValueError):
        device.share_pct(1.0, 0.0)


def test_tiny_supernet_calls():
    from benchlib import shapes

    with open(os.path.join(BENCH, "configs", "vit_resnas_tiny_supernet.json")) as f:
        cfg = json.load(f)
    net = shapes.to_tuple(cfg["network_def"])
    assert shapes.attention_calls(net, 224, 1024) == [
        ((1024, 17, 12, 64), 6), ((1024, 65, 12, 48), 6), ((1024, 257, 6, 32), 6)]
    ln = shapes.masked_ln_calls(net, cfg["space"], 224, 1024)
    assert [(k, c) for k, _, c in ln] == [((1024, 17, 1024), 13), ((1024, 65, 512), 13),
                                          ((1024, 257, 256), 13)]
    assert [w[0] for _, w, _ in ln] == [1024, 512, 256]


def test_reduce_trace_gaps_and_busy():
    from benchlib import device

    class Range:
        def __init__(self, start, end):
            self.start, self.end = start, end

    class Event:
        def __init__(self, name, start, end, cuda):
            from torch.autograd import DeviceType

            self.name, self.time_range = name, Range(start, end)
            self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU

    events = [Event("bench.train_step", 0, 100, False), Event("bench.drain", 100, 130, False),
              Event("k1", 10, 40, True), Event("k2", 30, 60, True), Event("k1", 110, 120, True)]
    out = device.reduce_trace(events, ("bench.train_step", "bench.drain"))
    assert out["busy_s"] == pytest.approx(60e-6)
    assert out["window_s"] == pytest.approx(120e-6)
    assert out["device_ops"][0] == ("k1", pytest.approx(40e-6))
    assert out["idle_gaps"][0] == ["bench.train_step", pytest.approx(50e-6)]
    assert out["idle_gaps"][1] == ["bench.train_step", pytest.approx(10e-6)]
