"""Stochastic depth (per-sample residual-branch drop).

Each sample's residual branch is zeroed with probability ``rate`` and the
survivors are rescaled by ``1 / (1 - rate)``. The draws come from an explicit
``torch.Generator`` (or a ``row_draws.RowShard`` of one), or are injected as
a ``(B,)`` keep tensor so tests can feed in another framework's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from .row_draws import uniform


def drop_path(x: torch.Tensor, rate: float, training: bool,
              keep: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep is None:
        keep = uniform((x.shape[0],), x.device, generator) < keep_prob
    keep = keep.to(device=x.device, dtype=torch.bool).view((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
