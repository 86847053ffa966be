"""Random erasing on the device (timm ``RandomErasing`` semantics).

Port of vit_search_tpu/data/erasing.py. Each image is erased with
probability ``prob``; an erased image gets a number of regions drawn
uniformly from ``[1, count]`` (timm ``max_count``), each a box whose area is
an independent fraction of the image. Modes (timm ``mode``): ``pixel``
fills each box with per-pixel N(0, 1) noise, ``rand`` with one N(0, 1)
colour per region, ``const`` with zeros. Images are normalized NHWC float.

The host draws each image's apply flag, region count and boxes
``(y0, x0, eh, ew)`` from a ``numpy.random.Generator``
(:func:`sample_erasing_draws`), with the JAX package's formulas and its
float32 arithmetic and truncation. The fill noise comes from a
``torch.Generator`` on the images' device. An :class:`ErasingDraws` injects
any of it, so tests can feed in the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

MODES = ("pixel", "rand", "const")
AREA_RANGE = (0.02, 1 / 3)
ASPECT_RANGE = (0.3, 3.3)


@dataclasses.dataclass
class ErasingDraws:
    """Random draws of one batch's erasing."""

    apply: np.ndarray     # (B,) bool: the image is erased
    regions: np.ndarray   # (B,) int in [1, count]: regions of an erased image
    boxes: np.ndarray     # (B, count, 4) int: y0, x0, eh, ew of each region
    # the fill of each region, or None to draw it from the step's generator:
    # pixel (count, B, H, W, C), rand (count, B, C)
    fill: Optional[torch.Tensor] = None


def sample_erasing_draws(rng: np.random.Generator, batch: int, height: int, width: int,
                         prob: float, count: int = 1) -> ErasingDraws:
    """Apply flags, region counts and boxes for ``batch`` images
    (erasing.py:37-57), in float32 like the JAX package: each region's area
    a uniform fraction ``AREA_RANGE`` of the image, its aspect log-uniform
    in ``ASPECT_RANGE``."""
    f32 = np.float32
    apply = rng.random(batch, dtype=np.float32) < f32(prob)
    regions = rng.integers(1, count + 1, batch)
    lo, hi = f32(AREA_RANGE[0]), f32(AREA_RANGE[1])
    area = (rng.random((batch, count), dtype=np.float32) * (hi - lo) + lo) * f32(height * width)
    log_lo, log_hi = np.log(f32(ASPECT_RANGE[0])), np.log(f32(ASPECT_RANGE[1]))
    aspect = np.exp(rng.random((batch, count), dtype=np.float32) * (log_hi - log_lo) + log_lo)
    eh = np.clip(np.sqrt(area * aspect).astype(np.int32), 1, height)
    ew = np.clip(np.sqrt(area / aspect).astype(np.int32), 1, width)
    y0 = rng.integers(0, np.maximum(1, height - eh + 1))
    x0 = rng.integers(0, np.maximum(1, width - ew + 1))
    return ErasingDraws(apply, regions, np.stack([y0, x0, eh, ew], axis=-1))


def random_erasing(images: torch.Tensor, prob: float = 0.25, mode: str = "pixel",
                   count: int = 1, draws: Optional[ErasingDraws] = None,
                   rng: Optional[np.random.Generator] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Erase up to ``count`` random boxes of each ``(B, H, W, C)`` image with
    probability ``prob``. Without ``draws``, the boxes come from ``rng`` and
    the fill from ``generator``."""
    if prob <= 0.0:
        return images
    if mode not in MODES:
        raise ValueError(f"unknown erasing mode {mode!r}; one of {MODES}")
    count = max(1, int(count))
    b, h, w, c = images.shape
    if draws is None:
        if rng is None:
            raise ValueError("random_erasing needs draws or an rng")
        draws = sample_erasing_draws(rng, b, h, w, prob, count)
    dev = images.device
    live = np.asarray(draws.apply)[:, None] & (np.arange(count)[None] <
                                               np.asarray(draws.regions)[:, None])
    boxes = torch.as_tensor(np.asarray(draws.boxes, np.int64), device=dev)
    on = torch.as_tensor(live, device=dev)
    iy = torch.arange(h, device=dev).view(1, h, 1)
    ix = torch.arange(w, device=dev).view(1, 1, w)
    for i in range(count):
        if not live[:, i].any():
            continue
        y0, x0, eh, ew = (t.view(b, 1, 1) for t in boxes[:, i].unbind(-1))
        box = ((iy >= y0) & (iy < y0 + eh) & (ix >= x0) & (ix < x0 + ew)
               & on[:, i].view(b, 1, 1))
        if mode == "const":
            fill = images.new_zeros(())
        elif draws.fill is not None:
            fill = draws.fill[i].to(device=dev, dtype=images.dtype)
            fill = fill if mode == "pixel" else fill.view(b, 1, 1, c)
        elif mode == "pixel":
            fill = torch.randn(images.shape, device=dev, dtype=images.dtype,
                               generator=generator)
        else:
            fill = torch.randn(b, 1, 1, c, device=dev, dtype=images.dtype,
                               generator=generator)
        images = torch.where(box[..., None], fill, images)
    return images
