"""Spans of the port's phases on the ``torch.profiler`` timeline.

``with span("vst.train.forward"): ...`` marks a phase of the host's work.
While a ``torch.profiler`` session runs, the span is a host operation
(``cpu_op``) of the profiler's own trace: it sits beside the kernels in
``prof.events()`` and in an exported chrome trace (the training CLI's
``--profile-dir``), on the same clock. While none runs it is one shared
no-op context, well under a microsecond.

Not ``torch.profiler.record_function``: that records a user annotation,
which the profiler mirrors on the device's timeline as a CUDA-typed event,
so a reader of device time would count the span as device work.

Names are ``vst.<layer>.<phase>``; a span opens where the work happens and
nests in the span of the work that caused it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a host operation while a
    profiler session runs, and the shared no-op context otherwise."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
