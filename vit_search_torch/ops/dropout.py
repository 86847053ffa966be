"""Dropout with explicit draws (flax ``nn.Dropout`` semantics).

Each element is kept with probability ``1 - rate`` and the survivors are
rescaled by ``1 / (1 - rate)``. A rate of 0, or eval mode, returns the input
and consumes no draw. The keep mask, of the input's full shape, comes from
``keeps`` (an iterator of injected boolean tensors, in call order) when
given, else from an explicit ``torch.Generator`` (or a
``row_draws.RowShard`` of one).
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from .row_draws import uniform


def dropout(x: torch.Tensor, rate: float, training: bool,
            keeps: Optional[Iterator[torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if keeps is not None:
        keep = next(keeps).to(device=x.device, dtype=torch.bool)
        if keep.shape != x.shape:
            raise ValueError(f"dropout keep of shape {tuple(keep.shape)} for an input of "
                             f"shape {tuple(x.shape)}")
    else:
        keep = uniform(x.shape, x.device, generator) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
