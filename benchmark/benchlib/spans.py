"""The program's phase spans in a ``torch.profiler`` trace: the card's idle
time split by the phase the host was in, and the CUDA runtime's
synchronisations counted inside each span.

The port marks its phases with ``vst.<layer>.<phase>`` host operations
(``vit_search_torch.utils.trace``), on the profiler's clock. The window and
the device's operations are :func:`device.reduce_trace`'s: from the first
of the benchmark's host spans to the last device operation's end. Each
stretch of that window in which no device operation runs is split by the
innermost ``vst.*`` span that covers it, on the thread that holds the
benchmark's spans, each phase of a parent span lasting until the parent's
next phase begins; what no such span covers is ``outside``. So the idle
parts sum to ``reduce_trace``'s ``window_s - busy_s``. A trace of a program
without the spans puts all its idle time ``outside``.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

from .device import _merge

PREFIX = "vst."
OUTSIDE = "outside"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
NOT_KERNELS = ("Memcpy", "Memset")


def _phases(spans: List[Tuple[str, float, float]]) -> List[Tuple[str, float, float]]:
    """``spans`` with each child span lasting until its next sibling
    begins: the host is still leaving one phase of a parent until the next
    phase of that parent starts. Spans without a parent keep their ends."""
    out = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    stack: List[int] = []
    last_child: Dict[int, int] = {}
    for i, (_, start, _) in enumerate(out):
        while stack and out[stack[-1]][2] <= start:
            stack.pop()
        if stack:
            prev = last_child.get(stack[-1])
            if prev is not None:
                name, s, e = out[prev]
                out[prev] = (name, s, max(e, start))
            last_child[stack[-1]] = i
        stack.append(i)
    return out


def _innermost(spans: List[Tuple[str, float, float]]) -> List[Tuple[float, float, str]]:
    """The host's timeline cut where a span begins or ends, each piece that
    some span covers labelled by the innermost one: the latest to begin,
    the earliest to end among those that began together."""
    points = sorted({t for _, s, e in spans for t in (s, e)})
    by_start = sorted(spans, key=lambda sp: sp[1])
    pieces, active, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(by_start) and by_start[i][1] <= a:
            active.append(by_start[i])
            i += 1
        active = [sp for sp in active if sp[2] > a]
        if active:
            pieces.append((a, b, max(active, key=lambda sp: (sp[1], -sp[2]))[0]))
    return pieces


def reduce(events, spans: Sequence[str]) -> Dict:
    """The program's spans over the window of ``reduce_trace(events, spans)``.

    ``events`` is ``prof.events()`` and ``spans`` the benchmark's own host
    spans. Returns ``window_s``; ``idle_s`` (label, seconds: the window's
    idle time by innermost ``vst.*`` span, and ``outside``); ``count``
    (name, the ``vst.*`` spans of that name); ``syncs`` (name, the CUDA
    runtime synchronisations whose host call starts inside a span of that
    name); ``kernels`` (the kernels on the device's timeline in the
    window). Empty where the trace holds no device operation or no
    benchmark span.
    """
    from torch.autograd import DeviceType

    device, host, program, syncs = [], [], [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name in spans:
            if e.device_type != DeviceType.CUDA:
                host.append((e.thread, start))
        elif e.device_type == DeviceType.CUDA:
            if end > start:
                device.append((e.name, start, end, e.is_user_annotation))
        elif e.name.startswith(PREFIX):
            program.append((e.thread, e.name, start, end))
        elif e.name in SYNCS:
            syncs.append(start)
    if not device or not host:
        return {}
    thread = collections.Counter(t for t, _ in host).most_common(1)[0][0]
    program = [(name, s, e) for t, name, s, e in program if t == thread]
    t0 = min(s for _, s in host)
    t1 = max(e for _, _, e, _ in device)
    busy = _merge([(max(s, t0), e) for _, s, e, _ in device if e > t0])
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)

    idle: Dict[str, float] = collections.defaultdict(float)
    pieces, j = _innermost(_phases(program)), 0
    for ga, gb in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= ga:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < gb:
            a, b, name = pieces[k]
            part = min(b, gb) - max(a, ga)
            if part > 0:
                idle[name] += part * 1e-6
                covered += part
            k += 1
        if gb - ga - covered > 1e-6:      # more than round-off, in microseconds
            idle[OUTSIDE] += (gb - ga - covered) * 1e-6

    count = collections.Counter(name for name, _, _ in program)
    inside = {name: sum(1 for t in syncs
                        if any(s <= t < e for n, s, e in program if n == name))
              for name in count}
    kernels = sum(1 for name, _, e, note in device
                  if e > t0 and not note and not name.startswith(NOT_KERNELS))
    return {"window_s": (t1 - t0) * 1e-6, "idle_s": dict(idle), "count": dict(count),
            "syncs": inside, "kernels": kernels}
