"""Inputs made from a run's seed: weights, images, labels and the random
draws of the checked train steps.

Each kind of input takes its own stream, keyed by ``(seed, tag, ...)``, so
the same seed gives the same inputs on both sides of the comparison.
Weights, images and the fill of erased boxes are made on the run's device
in a few large calls; the host draws (mixing partners, boxes) come from a
numpy generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

WEIGHTS, IMAGES, STEP = 1, 2, 3
INIT_STD = 0.02
ERASE_AREA = (0.02, 1 / 3)
ERASE_ASPECT = (0.3, 3.3)


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of a run seeded ``seed``."""
    words = np.random.SeedSequence([seed % 2**64, *tags]).generate_state(2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & (2**63 - 1)


def device_generator(seed: int, device, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *tags))


def host_generator(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *tags))


def _init_scale(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """``(offset, std)`` of a leaf: norm scales and running variances near
    1, running means near 0, convolutions by their fan-in, everything else
    (linear weights, biases, tokens, position tables) at the published
    init's 0.02."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1 and leaf in ("weight", "running_var"):
        return 1.0, 0.1
    if leaf == "running_mean":
        return 0.0, 0.1
    if len(shape) == 4:
        fan_in = int(np.prod(shape[1:]))
        return 0.0, float(fan_in) ** -0.5
    return 0.0, INIT_STD


def make_weights(shapes: Dict[str, Sequence[int]], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights for every named leaf, from one normal draw on the
    device, scaled per leaf."""
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=device_generator(seed, device, WEIGHTS),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        n = int(np.prod(shape))
        offset, std = _init_scale(name, shape)
        out[name] = (flat[at:at + n] * std + offset).view(shape)
        at += n
    return out


def make_images(seed: int, batches: int, batch: int, size: int, classes: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(batches, batch, size, size, 3)`` uint8 images and ``(batches,
    batch)`` labels, drawn on the device."""
    gen = device_generator(seed, device, IMAGES)
    images = torch.randint(0, 256, (batches, batch, size, size, 3), dtype=torch.uint8,
                           device=device, generator=gen)
    labels = torch.randint(0, classes, (batches, batch), device=device, generator=gen)
    return images, labels


@dataclasses.dataclass
class StepDraws:
    """The random draws of one train step.

    Token mixup: the first half of the batch pastes a box of ``(y0, x0, h,
    w)`` grid cells from partner ``perm1[i]``; the second half blends with
    partner ``perm2[i]`` by weight ``lam``. Erasing: image ``i`` is erased
    where ``erase[i]``, its box ``boxes[i] = (y0, x0, h, w)`` in pixels
    filled with ``fill[i]``'s normal noise. Stochastic depth: ``keeps[j]``
    is the ``(B,)`` keep draw of the ``j``-th residual branch.
    """

    perm1: np.ndarray
    box: Tuple[int, int, int, int]
    perm2: np.ndarray
    lam: float
    erase: np.ndarray
    boxes: np.ndarray
    fill: torch.Tensor
    keeps: List[torch.Tensor]


def _grid_box(rng: np.random.Generator, grid: int, lam: float) -> Tuple[int, int, int, int]:
    """A grid-aligned box covering about ``(1 - lam)`` of the grid."""
    area = int(np.float32(grid * grid) * np.float32(lam))
    max_len = min(grid, area)
    h = int(rng.integers(1, max(2, max_len)))
    w = area // h
    if w > grid:
        w = grid
        h = area // max(w, 1)
    y0 = int(rng.integers(0, max(1, grid - h + 1)))
    x0 = int(rng.integers(0, max(1, grid - w + 1)))
    return y0, x0, h, w


def make_step_draws(seed: int, index: int, batch: int, size: int, grid: int,
                    erase_prob: float, keep_rates: Sequence[float], device,
                    mix_alpha: float = 0.8) -> StepDraws:
    """The draws of checked step ``index`` of a run seeded ``seed``."""
    rng = host_generator(seed, STEP, index)
    half = batch // 2
    perm1 = rng.permutation(half)
    box = _grid_box(rng, grid, float(rng.beta(1.0, 1.0)))
    perm2 = rng.permutation(batch - half)
    lam = float(rng.beta(mix_alpha, mix_alpha))
    erase = rng.random(batch) < erase_prob
    area = rng.uniform(*ERASE_AREA, batch) * size * size
    aspect = np.exp(rng.uniform(np.log(ERASE_ASPECT[0]), np.log(ERASE_ASPECT[1]), batch))
    eh = np.clip(np.sqrt(area * aspect).astype(np.int64), 1, size)
    ew = np.clip(np.sqrt(area / aspect).astype(np.int64), 1, size)
    y0 = rng.integers(0, size - eh + 1)
    x0 = rng.integers(0, size - ew + 1)
    gen = device_generator(seed, device, STEP, index)
    fill = torch.randn((batch, size, size, 3), generator=gen, device=device)
    keeps = [torch.rand((batch,), generator=gen, device=device) < 1.0 - r for r in keep_rates]
    return StepDraws(perm1, box, perm2, lam, erase, np.stack([y0, x0, eh, ew], -1), fill, keeps)
