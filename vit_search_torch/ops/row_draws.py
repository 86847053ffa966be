"""Random draws of one process's rows of the global batch.

In a multi-process train step each process holds the rows ``[lo, hi)`` of
the global batch. A :class:`RowShard` stands where the step's
``torch.Generator`` would: every per-example draw (stochastic depth,
dropout) is made at the global batch's shape and cut to the process's rows,
so the processes together draw exactly what one process draws for the whole
batch, and the generator advances alike on every process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class RowShard:
    generator: torch.Generator
    global_batch: int
    lo: int
    hi: int


def uniform(shape: Sequence[int], device,
            generator: Optional[Union[torch.Generator, RowShard]]) -> torch.Tensor:
    """``torch.rand(shape)`` whose leading dim is the batch, from a generator
    or a :class:`RowShard` of one."""
    if not isinstance(generator, RowShard):
        return torch.rand(tuple(shape), device=device, generator=generator)
    if shape[0] != generator.hi - generator.lo:
        raise ValueError(f"a draw for {shape[0]} rows from a shard of "
                         f"{generator.hi - generator.lo}")
    full = torch.rand((generator.global_batch, *shape[1:]), device=device,
                      generator=generator.generator)
    return full[generator.lo:generator.hi]
