"""Per-process index samplers.

A copy of vit_search_tpu/data/samplers.py (numpy only). Each process feeds
its devices a distinct shard of the global batch; these samplers generate
the per-process index streams of the reference's rank-sharded torch
samplers:

- :class:`RepeatedAugmentSampler` — 3x repeated augmentation, epoch-seeded
  shuffle, interleaved by rank, truncated to ``floor(len/256*256/replicas)``
  selections per rank (reference samplers.py:12-63),
- :class:`ShardedSampler` — epoch-seeded shuffled (train) or ordered (eval)
  shard with padding to equal length (torch ``DistributedSampler`` /
  timm ``OrderedDistributedSampler`` parity, datasets.py:154-156).

Samplers yield numpy index arrays; ``set_epoch`` reseeds like the reference
(``sampler.set_epoch`` call in main.py:464).
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class RepeatedAugmentSampler:
    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 repeats: int = 3, selected_round: int = 256):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"bad rank {rank} of {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.repeats = repeats
        self.epoch = 0
        self.num_samples = int(
            math.ceil(dataset_len * repeats / num_replicas))
        self.total_size = self.num_samples * num_replicas
        if selected_round:
            self.num_selected_samples = int(
                math.floor(dataset_len // selected_round * selected_round
                           / num_replicas))
        else:
            self.num_selected_samples = int(math.ceil(dataset_len / num_replicas))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_selected_samples

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.epoch)
        order = rng.permutation(self.dataset_len)
        indices: List[int] = [int(i) for i in order for _ in range(self.repeats)]
        indices += indices[: self.total_size - len(indices)]
        assert len(indices) == self.total_size
        shard = indices[self.rank:self.total_size:self.num_replicas]
        return iter(shard[: self.num_selected_samples])


class ShardedSampler:
    """Shuffled (train) or ordered (eval) equal-length shard."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 shuffle: bool = True):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"bad rank {rank} of {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0
        self.num_samples = int(math.ceil(dataset_len / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    @property
    def num_valid_samples(self) -> int:
        """Leading entries of this (ordered) shard that are real dataset
        images rather than cross-shard padding.  The ordered shard is the
        contiguous chunk ``[rank*num_samples, (rank+1)*num_samples)`` of
        the padded index list, so padding occupies exactly the positions
        past ``dataset_len``.  Lets eval score every image exactly once
        across processes (vs the reference's counted-duplicates tail,
        timm OrderedDistributedSampler via datasets.py:154-184)."""
        if self.shuffle:
            raise ValueError("num_valid_samples is defined for ordered "
                             "(eval) shards only")
        start = self.rank * self.num_samples
        return max(0, min(self.num_samples, self.dataset_len - start))

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            indices = list(np.random.default_rng(self.epoch)
                           .permutation(self.dataset_len))
        else:
            indices = list(range(self.dataset_len))
        indices += indices[: self.total_size - len(indices)]
        if self.shuffle:
            return iter(int(i) for i in indices[self.rank:self.total_size:self.num_replicas])
        # ordered shard: contiguous chunks, timm OrderedDistributedSampler style
        start = self.rank * self.num_samples
        return iter(int(i) for i in indices[start:start + self.num_samples])
