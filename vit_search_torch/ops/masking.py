"""Channel masking: the weight-sharing mechanism of supernet training.

Port of the JAX package's ``ops/masking.py``. A host-side sampler
(:class:`ChannelDropSchedule`, numpy) emits per-architecture integer keep
counts; :func:`make_channel_mask` turns per-example counts into ``(B, 1, C)``
prefix masks on the device. Masks always keep a prefix of channels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

DEFAULT_NUM_WARMUP_EPOCHS = 15


def make_channel_mask(keep_counts: torch.Tensor, num_channels: int,
                      dtype: torch.dtype = torch.bool) -> torch.Tensor:
    """``(B,)`` keep counts -> ``(B, 1, C)`` mask; channel ``c`` of example
    ``b`` is kept iff ``c < keep_counts[b]``."""
    iota = torch.arange(num_channels, device=keep_counts.device).view(1, 1, -1)
    return (iota < keep_counts.to(torch.int64).view(-1, 1, 1)).to(dtype)


def expand_arch_counts(arch_counts: torch.Tensor, batch: int) -> torch.Tensor:
    """Tile ``(A,)`` per-architecture counts to ``(batch,)`` per-example
    counts, round-robin: example ``b`` gets architecture ``b % A``."""
    (num_archs,) = arch_counts.shape
    if batch % num_archs != 0:
        raise ValueError(f"batch {batch} not divisible by arch count {num_archs}")
    return arch_counts.repeat(batch // num_archs)


class ChannelDropSchedule:
    """Host-side keep-count sampler for one ChannelDrop site (numpy)."""

    def __init__(self, num_channels_to_keep: Sequence[int],
                 num_warmup_epochs: int = DEFAULT_NUM_WARMUP_EPOCHS,
                 example_per_arch: Optional[int] = None,
                 single_arch: bool = False):
        widths = np.sort(np.asarray(num_channels_to_keep))[::-1]
        if widths.size == 0:
            raise ValueError("num_channels_to_keep is empty")
        self.widths = widths.astype(np.int64)
        self.num_channels = int(widths[0])
        self.num_warmup_epochs = int(num_warmup_epochs)
        self.example_per_arch = example_per_arch
        self.single_arch = single_arch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    @property
    def num_active_widths(self) -> int:
        """Progressive warmup: ``min(1 + floor(epoch*(n-1)/warmup), n)``."""
        n = len(self.widths)
        if self.num_warmup_epochs == 0:
            return n
        k = 1 + math.floor(self.epoch * (n - 1) / self.num_warmup_epochs)
        return max(1, min(k, n))

    def _bank(self, num_masks: int) -> np.ndarray:
        active = self.widths[: self.num_active_widths]
        num_cycles = 1 if self.single_arch else math.ceil(num_masks / len(active))
        return np.tile(active, num_cycles)

    def full_counts(self) -> np.ndarray:
        """Eval-mode counts: every channel kept (reference channel_drop.py:84-89)."""
        return np.full((1,), self.num_channels, dtype=np.int64)

    def sample(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        """Per-architecture keep counts for one step: permute the bank,
        truncate. Shape ``(1,)`` for single-arch sites, else
        ``(batch // example_per_arch,)``."""
        if self.single_arch:
            num_masks = 1
        else:
            if self.example_per_arch is None:
                raise ValueError("example_per_arch required for multi-arch sites")
            if batch % self.example_per_arch != 0:
                raise ValueError(
                    f"batch {batch} not divisible by example_per_arch {self.example_per_arch}")
            num_masks = batch // self.example_per_arch
        bank = self._bank(num_masks)
        if num_masks > len(bank):
            raise ValueError("batch has more sub-batches than mask bank entries")
        return rng.permutation(bank)[:num_masks]
