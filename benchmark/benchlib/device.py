"""The card: its name and power limit, the bound of a kernel's work, and the
reduction of a ``torch.profiler`` trace to busy time, idle gaps and the
operations that took most time.
"""

from __future__ import annotations

import math
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import frozen

NAME_CHARS = 160
PEAK_BF16 = frozen.PEAK_BF16
PEAK_BYTES = frozen.PEAK_BYTES


def card_line() -> str:
    """``name, power limit`` of card 0 as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def kernel_seconds(fn: Callable, make: Callable[[], tuple], reps: int) -> Optional[float]:
    """Device seconds per call of ``fn(*args)``: the sum of the durations of
    the device operations it launches, from a ``torch.profiler`` trace of
    ``reps`` calls, so that the host's time between them drops out. The
    calls rotate over sets of inputs from ``make()`` that together exceed
    twice the L2 cache, so each call reads from HBM. ``None`` where the
    trace holds no device operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sets = [make()]
    size = frozen.nbytes(*(t for t in sets[0] if isinstance(t, torch.Tensor)))
    while len(sets) * size < 2 * frozen.L2_BYTES:
        sets.append(make())
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    total_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    return total_us * 1e-6 / reps if total_us > 0 else None


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least seconds the card takes: bytes over HBM bandwidth or bf16
    operations over the tensor cores' peak, whichever is longer."""
    return frozen.bound(bytes_moved, flops, PEAK_BF16)[0] / 1e3


# --- traces ---------------------------------------------------------------

def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(events, spans: Sequence[str], top: int = 10) -> Dict:
    """Busy and idle time of the card over a profiled window.

    ``events`` is ``prof.events()``; the window runs from the first of the
    benchmark's host spans named in ``spans`` to the last device operation's
    end. Returns ``busy_s``, ``window_s``, ``device_ops`` (name, seconds:
    the operations that took most device time) and ``idle_gaps`` (label,
    seconds: the longest stretches with no device operation, each labelled
    by the benchmark span the host was in when it began).
    """
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name in spans:
            # a span shows on the device's timeline too, as an annotation
            if e.device_type != DeviceType.CUDA:
                host.append((e.name, start, end))
        elif e.device_type == DeviceType.CUDA and end > start:
            device.append((e.name[:NAME_CHARS], start, end))
    if not device or not host:
        return {}
    t0 = min(s for _, s, _ in host)
    t1 = max(e for _, _, e in device)
    busy = _merge([(max(s, t0), e) for _, s, e in device if e > t0])
    by_name: Dict[str, float] = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)

    def label(t: float) -> str:
        inside = [(s, name) for name, s, e in host if s <= t < e]
        return max(inside)[1] if inside else "outside the benchmark's spans"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": [[label(a), (b - a) * 1e-6] for a, b in gaps[:top]]}


# --- operations and bytes of the kernels' work --------------------------------

def attention_fwd_flops(b: int, n: int, h: int, d: int) -> float:
    """``q k^T`` and ``p v``: 2 products of B*H*N*N*D multiply-adds."""
    return 4.0 * b * h * n * n * d


def attention_bwd_flops(b: int, n: int, h: int, d: int) -> float:
    """The scores again, then dV, dP, dQ and dK: 5 such products."""
    return 10.0 * b * h * n * n * d


def attention_bytes(b: int, n: int, h: int, d: int, backward: bool, itemsize: int = 2) -> float:
    """Forward: the packed (B, N, 3W) projection in, the (B, N, W) output
    out. Backward: the projection and the output's cotangent in, the packed
    cotangent out."""
    w = h * d
    if backward:
        return float(itemsize * b * n * (3 * w + w + 3 * w))
    return float(itemsize * b * n * (3 * w + w))


def masked_ln_bytes(b: int, n: int, c: int, backward: bool, itemsize: int = 2) -> float:
    """Forward: x and a per-example mask in, float32 weight and bias in, y
    out. Backward: x, the mask, the weight and the cotangent in, the input's
    cotangent and float32 weight and bias cotangents out."""
    rows, mask, vec = b * n * c * itemsize, b * c * itemsize, c * 4
    if backward:
        return float(2 * rows + mask + vec + rows + 2 * vec)
    return float(rows + mask + 2 * vec + rows)


def share_pct(bound_seconds: float, measured_seconds: float) -> float:
    if not measured_seconds > 0 or not math.isfinite(measured_seconds):
        raise ValueError("no measured time")
    return 100.0 * bound_seconds / measured_seconds
