"""Frozen copies of the data-sheet peaks and the bound arithmetic of
``chip_smoke.py`` (the port's bring-up smoke run), taken word for word so
that the yardstick stays as it is while the program changes.
``benchmark/tests/test_bench_frozen.py`` holds each copy to its original.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
L2_BYTES = 50 * 2**20


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)
