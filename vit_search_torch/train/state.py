"""Train state of the port: the step counter and the EMA of the parameters.

The model (parameters and BN statistics) and the optimizer hold the rest of
what the JAX package's ``TrainState`` carries. The EMA follows the reference
``ModelEmaV2``: per step ``ema = ema * decay + params * (1 - decay)``, decay
0.99996 (reference main.py:93,357-363), over the parameters only, as the JAX
tree has it: BN statistics are not averaged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch


@dataclasses.dataclass
class TrainState:
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None   # name -> float32 copy


def init_ema(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Float32 copies of ``params`` that share no storage with them."""
    return {name: p.detach().to(torch.float32, copy=True) for name, p in params.items()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float) -> None:
    """``e <- e * decay + p * (1 - decay)`` for every entry, in place, in the
    JAX package's order of operations (vit_search_tpu/train/state.py:36-38),
    as three multi-tensor launches over all entries."""
    ema = list(ema_params.values())
    scaled = torch._foreach_mul([params[name].float() for name in ema_params], 1.0 - decay)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, scaled)
