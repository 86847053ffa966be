"""On the card: the profiler's device timeline gives the kernel timing and
the busy share that the per-layer metrics read. Skips without a card."""

import pytest

pytestmark = pytest.mark.gpu


def test_kernel_seconds_reads_device_time(card):
    import torch
    from benchlib import device

    def make():
        return (torch.randn(4096, 4096, device=card, dtype=torch.bfloat16),)

    seconds = device.kernel_seconds(lambda a: a @ a, make, 5)
    # 2 * 4096^3 operations cannot take less than their bound
    assert seconds >= device.bound_s(0.0, 2.0 * 4096 ** 3)


def test_trace_has_busy_time(card):
    import torch
    from benchlib import device
    from torch.profiler import ProfilerActivity, profile, record_function

    a = torch.randn(2048, 2048, device=card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.step"):
            for _ in range(5):
                a = a @ a / 2048
        torch.cuda.synchronize()
    out = device.reduce_trace(prof.events(), ("bench.step",))
    assert 0 < out["busy_s"] <= out["window_s"]
    assert out["device_ops"]
