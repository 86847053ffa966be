"""Optimizer and LR schedule.

Port of vit_search_tpu/train/optim.py:

- AdamW, base lr 5e-4 scaled by ``global_batch / 512``, betas/eps at the
  torch defaults, weight decay 0.05. ``torch.optim.AdamW``'s update equals
  optax ``adamw``'s: ``p <- p * (1 - lr*wd) - lr * m_hat / (sqrt(v_hat) + eps)``;
- weight decay applies to parameters of rank > 1 except the token table
  (``pos_embed`` included), the JAX package's mask (optim.py:180-188), and
  except any whose name holds one of the model's
  ``no_weight_decay_keywords()`` (SwinV2's ``cpb_mlp`` and ``logit_scale``);
- the per-epoch LR curve of timm 0.3.2's schedulers (cosine, step, tanh,
  optional noise), constant within an epoch;
- ``clip_grad``: optax ``clip_by_global_norm`` before AdamW, as the JAX
  package chains it (optim.py:196-197). :func:`make_optimizer` keeps the
  value in each parameter group (``"clip_grad"``), where the train step,
  which already holds the global norm, reads it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    base_lr: float = 5e-4
    min_lr: float = 1e-5
    warmup_lr: float = 1e-6
    warmup_epochs: int = 5
    epochs: int = 300
    weight_decay: float = 0.05
    clip_grad: Optional[float] = None
    global_batch_size: int = 1024
    lr_scale_divisor: int = 512     # lr = base_lr * global_batch / 512
    steps_per_epoch: int = 1
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # --lr-noise [pct] or [on_pct, off_pct] (fractions of total epochs)
    lr_noise: Optional[Union[float, Sequence[float]]] = None
    lr_noise_pct: float = 0.67
    lr_noise_std: float = 1.0       # stored-but-unused, same quirk as timm 0.3.2
    seed: int = 0
    sched: str = "cosine"           # cosine | step | tanh
    decay_epochs: float = 30.0
    decay_rate: float = 0.1

    @property
    def scaled_lr(self) -> float:
        return self.base_lr * self.global_batch_size / self.lr_scale_divisor


def timm_epoch_lrs(config: OptimConfig) -> np.ndarray:
    """One LR per training epoch, as timm 0.3.2's schedulers give them
    (``t_initial = epochs``, no warmup prefix: the cosine spans the warmup
    epochs too)."""
    peak = float(config.scaled_lr)
    epochs = max(1, int(config.epochs))
    warmup_t = int(config.warmup_epochs)
    sched = config.sched
    if sched not in ("cosine", "step", "tanh"):
        raise ValueError(f"--sched {sched!r} is not implemented (supported: cosine, "
                         f"step, tanh)")
    if sched == "step" and not config.decay_epochs > 0:
        raise ValueError(f"--decay-epochs must be > 0 for --sched step "
                         f"(got {config.decay_epochs})")
    lrs = np.empty((epochs,), np.float64)
    for t in range(epochs):
        if warmup_t and t < warmup_t:
            lrs[t] = config.warmup_lr + t * (peak - config.warmup_lr) / warmup_t
        elif sched == "cosine":
            lrs[t] = config.min_lr + 0.5 * (peak - config.min_lr) * (
                1.0 + math.cos(math.pi * t / epochs))
        elif sched == "step":
            lrs[t] = peak * config.decay_rate ** (t // config.decay_epochs)
        else:
            tr = t / epochs
            lrs[t] = config.min_lr + 0.5 * (peak - config.min_lr) * (
                1.0 - math.tanh(-6.0 * (1.0 - tr) + 4.0 * tr))
    if config.lr_noise is not None:
        lrs = _apply_timm_lr_noise(lrs, config)
    return lrs


def _apply_timm_lr_noise(lrs: np.ndarray, config: OptimConfig) -> np.ndarray:
    """timm 0.3.2 ``Scheduler._add_noise``: per-epoch multiplicative noise
    from ``torch.Generator().manual_seed(seed + t)``, resampled until
    ``|n| < noise_pct``."""
    noise = config.lr_noise
    epochs = len(lrs)
    if isinstance(noise, (list, tuple)):
        bounds = [float(n) * epochs for n in noise]
        if len(bounds) == 1:
            bounds = bounds[0]
    else:
        bounds = float(noise) * epochs
    out = lrs.copy()
    for t in range(epochs):
        apply = bounds[0] <= t < bounds[1] if isinstance(bounds, list) else t >= bounds
        if not apply:
            continue
        g = torch.Generator()
        g.manual_seed(config.seed + t)
        while True:
            n = torch.randn(1, generator=g).item()
            if abs(n) < config.lr_noise_pct:
                break
        out[t] = out[t] + out[t] * n
    return out


def lr_schedule(config: OptimConfig) -> Callable[[int], float]:
    """Per-step LR: the epoch's value, constant within the epoch."""
    lrs = timm_epoch_lrs(config).astype(np.float32)
    spe = max(1, int(config.steps_per_epoch))

    def schedule(step: int) -> float:
        return float(lrs[min(max(int(step) // spe, 0), len(lrs) - 1)])

    return schedule


def weight_decay_groups(model: nn.Module) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """``(decay, no_decay)``: rank > 1 parameters except ``tokens`` and
    those named by the model's ``no_weight_decay_keywords()`` decay."""
    skip = getattr(model, "no_weight_decay_keywords", tuple)()
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if (p.ndim > 1 and name.split(".")[-1] != "tokens"
                and not any(k in name for k in skip)):
            decay.append(p)
        else:
            no_decay.append(p)
    return decay, no_decay


@torch.no_grad()
def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the float32 L2 norm of all ``tensors`` together,
    each tensor's sum of squares accumulated in float64. (The CPU's float32
    norm of a tensor sums in order: 9e-5 off at a 5 M-element gradient of the
    Small supernet, where XLA's tree reduction is not.)"""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax ``clip_by_global_norm(max_norm)`` in place, given the global
    norm of ``grads``: each becomes ``(g / norm) * max_norm`` when ``norm >=
    max_norm`` and stays as it is otherwise; no epsilon. (Not
    ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm and
    always scales.) The choice is made on the device: no host sync."""
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, torch.full_like(norm, max_norm), one))


def make_optimizer(config: OptimConfig, model: nn.Module) -> torch.optim.AdamW:
    """AdamW over two parameter groups (decayed / not), each carrying
    ``clip_grad``. The train step sets each group's ``lr`` from the schedule
    before every update."""
    decay, no_decay = weight_decay_groups(model)
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": config.weight_decay, "clip_grad": config.clip_grad},
         {"params": no_decay, "weight_decay": 0.0, "clip_grad": config.clip_grad}],
        lr=float(lr_schedule(config)(0)), betas=(config.beta1, config.beta2), eps=config.eps)
