"""Shifted-patch token mixup on the device.

Port of the token-mixup half of vit_search_tpu/data/mixup.py.
``switch_token_mix`` gives the first half of the batch patch-aligned CutMix
with per-patch targets and the second half image-level mixup with replicated
patch targets (the ``'seq'`` patch-prediction mode).

The random draws (permutations, mixing weight, box) are host-side scalars
drawn from a ``numpy.random.Generator`` by :func:`sample_token_mix_draws`, or
injected as a :class:`TokenMixDraws` so tests can feed in another framework's
draws. Mixing itself runs on the images' device. Mixup/CutMix (timm
``Mixup``) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class PatchMixDraws:
    perm: np.ndarray   # (half,) partner of each example
    y0: int            # box origin and size, in grid cells
    x0: int
    h: int
    w: int


@dataclasses.dataclass
class ImageMixDraws:
    perm: np.ndarray
    lam: float


@dataclasses.dataclass
class TokenMixDraws:
    patch: PatchMixDraws   # first half of the batch
    image: ImageMixDraws   # second half


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def sample_rand_box(rng: np.random.Generator, grid: int, lam: float) -> Tuple[int, int, int, int]:
    """Random patch-aligned box covering about ``(1 - lam)`` of the grid:
    ``(y0, x0, h, w)`` with the JAX package's bounds (mixup.py:37-59)."""
    area = int(np.float32(grid * grid) * np.float32(lam))
    max_len = min(grid, area)

    def randint(low, high):
        return int(rng.integers(low, high if high > low else low + 1))

    h = randint(1, max(1, max_len - 1))
    w = area // h
    if w > grid:
        w = grid
        h = area // max(w, 1)
    y0 = randint(0, max(0, grid - h))
    x0 = randint(0, max(0, grid - w))
    return y0, x0, h, w


def sample_token_mix_draws(rng: np.random.Generator, batch: int, grid: int,
                           alpha: float = 0.8) -> TokenMixDraws:
    half = batch // 2
    perm1 = rng.permutation(half)
    y0, x0, h, w = sample_rand_box(rng, grid, rng.beta(1.0, 1.0))
    perm2 = rng.permutation(batch - half)
    return TokenMixDraws(PatchMixDraws(perm1, y0, x0, h, w),
                         ImageMixDraws(perm2, float(rng.beta(alpha, alpha))))


def patch_mixup(samples: torch.Tensor, labels: torch.Tensor, grid: int, num_classes: int,
                smoothing: float, draws: PatchMixDraws):
    """Patch-aligned CutMix with per-patch targets; NHWC ``samples``."""
    b, img_h, _, _ = samples.shape
    patch = img_h // grid
    dev = samples.device
    perm = torch.as_tensor(np.array(draws.perm), dtype=torch.long, device=dev)
    gy = torch.arange(grid, device=dev).view(-1, 1)
    gx = torch.arange(grid, device=dev).view(1, -1)
    box = ((gy >= draws.y0) & (gy < draws.y0 + draws.h)
           & (gx >= draws.x0) & (gx < draws.x0 + draws.w))
    pix = box.repeat_interleave(patch, 0).repeat_interleave(patch, 1)
    mixed = torch.where(pix[None, :, :, None], samples[perm], samples)

    onehot = one_hot_smooth(labels, num_classes, smoothing)
    grid_targets = onehot[:, None, None, :].expand(b, grid, grid, num_classes)
    patch_targets = torch.where(box[None, :, :, None], grid_targets[perm], grid_targets)
    patch_targets = patch_targets.reshape(b, grid * grid, num_classes)

    lam = float(np.float32(1.0) - np.float32(draws.h * draws.w) / np.float32(grid * grid))
    targets = onehot * lam + onehot[perm] * (1.0 - lam)
    return mixed, targets, patch_targets


def image_mixup(samples: torch.Tensor, labels: torch.Tensor, grid: int, num_classes: int,
                smoothing: float, draws: ImageMixDraws):
    """Image-level mixup with replicated patch targets."""
    b = samples.shape[0]
    perm = torch.as_tensor(np.array(draws.perm), dtype=torch.long, device=samples.device)
    lam = draws.lam
    mixed = samples * lam + samples[perm] * (1.0 - lam)
    y = one_hot_smooth(labels, num_classes, smoothing)
    targets = y * lam + y[perm] * (1.0 - lam)
    patch_targets = targets[:, None, :].expand(b, grid * grid, num_classes)
    return mixed, targets, patch_targets


def switch_token_mix(samples: torch.Tensor, labels: torch.Tensor, grid: int,
                     num_classes: int, smoothing: float = 0.1,
                     draws: Optional[TokenMixDraws] = None,
                     rng: Optional[np.random.Generator] = None):
    """Half-batch patch CutMix + half-batch image mixup ('seq' mode).

    Returns ``(mixed, targets (B, K), patch_targets (B, grid*grid, K))``.
    """
    b = samples.shape[0]
    if b % 2:
        raise ValueError("switch_token_mix needs an even batch")
    if draws is None:
        if rng is None:
            raise ValueError("switch_token_mix needs draws or an rng")
        draws = sample_token_mix_draws(rng, b, grid)
    half = b // 2
    s1, t1, p1 = patch_mixup(samples[:half], labels[:half], grid, num_classes,
                             smoothing, draws.patch)
    s2, t2, p2 = image_mixup(samples[half:], labels[half:], grid, num_classes,
                             smoothing, draws.image)
    return torch.cat([s1, s2]), torch.cat([t1, t2]), torch.cat([p1, p2])
