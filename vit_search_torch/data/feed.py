"""Device feed: host batches onto one device, ahead of the step.

One device's counterpart of ``prefetch_to_mesh``
(vit_search_tpu/parallel/mesh.py:73-99) and of timm's ``PrefetchLoader``
(reference datasets.py:144-184). On a CUDA device each uint8 NHWC batch
is copied into pinned host memory and sent to the card by ``non_blocking``
copies on a side stream, ``depth`` batches ahead of the consumer; an event
recorded after each batch's copies is waited on by the consumer's stream
before it is handed out, so the step never reads a batch whose copy is in
flight and the host never waits for a copy. Labels go as int64, the dtype
the losses index with. Normalizing stays in the step
(``train.engine.normalize``).

On the CPU the batches are wrapped as tensors without a copy.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


def _host_tensors(batch) -> Tuple[torch.Tensor, torch.Tensor]:
    images, labels = batch
    return (torch.from_numpy(np.ascontiguousarray(images)),
            torch.from_numpy(np.asarray(labels, dtype=np.int64)))


def prefetch_to_device(batches: Iterable, device, depth: int = 2
                       ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield ``(images, labels)`` of ``batches`` (numpy ``(B, H, W, 3)``
    uint8, ``(B,)`` ints) as tensors on ``device``, staying ``depth`` batches
    ahead of the consumer on a CUDA device."""
    device = torch.device(device)
    it = iter(batches)
    if device.type != "cuda":
        for batch in it:
            yield _host_tensors(batch)
        return

    copy_stream = torch.cuda.Stream(device)
    buf: collections.deque = collections.deque()

    def enqueue() -> bool:
        try:
            batch = next(it)
        except StopIteration:
            return False
        # A pinned buffer is allocated per batch, never refilled by this
        # feed: PyTorch's pinned-memory allocator hands a freed block out
        # again only after the copies recorded on it have finished, so a
        # buffer cannot be overwritten while its copy is in flight.
        pinned = [t.pin_memory() for t in _host_tensors(batch)]
        with torch.cuda.stream(copy_stream):
            on_device = [t.to(device, non_blocking=True) for t in pinned]
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        buf.append((on_device, ready))
        return True

    for _ in range(max(1, depth)):
        if not enqueue():
            break
    while buf:
        (images, labels), ready = buf.popleft()
        enqueue()
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        # the tensors were allocated on the copy stream: tell the caching
        # allocator that the consumer's stream uses them too
        images.record_stream(stream)
        labels.record_stream(stream)
        yield images, labels
