"""Mixup, CutMix and shifted-patch token mixup on the device.

Port of vit_search_tpu/data/mixup.py:

- ``switch_token_mix`` gives the first half of the batch patch-aligned CutMix
  with per-patch targets and the second half image-level mixup with
  replicated patch targets (the ``'seq'`` patch-prediction mode);
- ``mixup_cutmix`` is timm's ``Mixup``: each draw mixes an image with its
  partner in the flipped batch (``x.flip(0)``), by a blend (mixup) or a
  pasted box (CutMix), the targets mixed by the realized weight.

The random draws (permutations, mixing weights, boxes) are host-side values
drawn from a ``numpy.random.Generator`` (:func:`sample_token_mix_draws`,
:func:`sample_mixup_draws`), or injected as a :class:`TokenMixDraws` or a
:class:`MixupDraws` so tests can feed in another framework's draws. Mixing
itself runs on the images' device with no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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


# --- timm Mixup / CutMix ------------------------------------------------------

MIXUP_MODES = ("batch", "elem", "pair")
Scalar = Union[float, int, bool, np.ndarray]


@dataclasses.dataclass
class MixupDraws:
    """Random draws of one batch's ``mixup_cutmix``: scalars in ``batch``
    mode, ``(B,)`` arrays in ``elem`` and ``pair`` mode (``pair``: the
    second half mirrors the first, ``[i]`` and ``[B-1-i]`` equal).

    ``lam0 == 1`` means the draw was not applied (the ``mixup_prob`` gate);
    the box ``[y0, y1) x [x0, x1)`` is the one CutMix pastes from the
    partner, sampled even for a mixup draw, as the JAX package does."""

    lam0: Scalar          # float32 mixing weight before the box correction
    use_cutmix: Scalar    # bool
    y0: Scalar
    y1: Scalar
    x0: Scalar
    x1: Scalar


def _mix_params(rng: np.random.Generator, n: Optional[int], mixup_alpha: float,
                cutmix_alpha: float, switch_prob: float, mixup_prob: float):
    """``(lam0, use_cutmix)`` of shape ``n`` (a scalar for ``None``), as
    ``_sample_mix_params`` (mixup.py:118-142) draws them."""
    f32 = np.float32
    shape = () if n is None else (n,)
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        use_cutmix = rng.random(shape, dtype=np.float32) < f32(switch_prob)
        lam = np.where(use_cutmix, rng.beta(cutmix_alpha, cutmix_alpha, shape),
                       rng.beta(mixup_alpha, mixup_alpha, shape))
    elif mixup_alpha > 0.0:
        use_cutmix = np.zeros(shape, bool)
        lam = rng.beta(mixup_alpha, mixup_alpha, shape)
    elif cutmix_alpha > 0.0:
        use_cutmix = np.ones(shape, bool)
        lam = rng.beta(cutmix_alpha, cutmix_alpha, shape)
    else:
        raise ValueError("one of mixup_alpha/cutmix_alpha must be > 0")
    apply = rng.random(shape, dtype=np.float32) < f32(mixup_prob)
    return np.where(apply, lam.astype(np.float32), f32(1.0)), use_cutmix


def _cutmix_boxes(rng: np.random.Generator, img_h: int, img_w: int, lam0: np.ndarray,
                  cutmix_minmax=None):
    """Box corners ``(y0, y1, x0, x1)`` shaped like ``lam0``, as
    ``_cutmix_box`` (mixup.py:145-178) computes them: side ratio
    ``sqrt(1 - lam)`` in float32, sides truncated to int32, a uniform centre,
    the box clipped at the borders; with ``cutmix_minmax=(lo, hi)`` each side
    a uniform integer in ``[int(size * lo), int(size * hi))`` and the box
    inside the image."""
    shape = np.shape(lam0)
    if cutmix_minmax is not None:
        lo, hi = cutmix_minmax
        ch = rng.integers(int(img_h * lo), int(img_h * hi), shape)
        cw = rng.integers(int(img_w * lo), int(img_w * hi), shape)
        y0 = rng.integers(0, img_h - ch)
        x0 = rng.integers(0, img_w - cw)
        return y0, y0 + ch, x0, x0 + cw
    cut_rat = np.sqrt(np.float32(1.0) - np.asarray(lam0, np.float32))
    ch = (np.float32(img_h) * cut_rat).astype(np.int32)
    cw = (np.float32(img_w) * cut_rat).astype(np.int32)
    cy = rng.integers(0, img_h, shape)
    cx = rng.integers(0, img_w, shape)
    return (np.clip(cy - ch // 2, 0, img_h), np.clip(cy + ch // 2, 0, img_h),
            np.clip(cx - cw // 2, 0, img_w), np.clip(cx + cw // 2, 0, img_w))


def sample_mixup_draws(rng: np.random.Generator, batch: int, img_h: int, img_w: int,
                       mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                       switch_prob: float = 0.5, mixup_prob: float = 1.0,
                       mode: str = "batch", cutmix_minmax=None) -> MixupDraws:
    """The draws of one ``mixup_cutmix`` call (timm ``Mixup._params_per_batch``
    / ``_params_per_elem``); ``cutmix_minmax`` forces CutMix on, as timm
    does."""
    _check_mode(mode, batch, cutmix_minmax)
    if cutmix_minmax is not None:
        cutmix_alpha = 1.0
    n = None if mode == "batch" else (batch // 2 if mode == "pair" else batch)
    lam0, use_cutmix = _mix_params(rng, n, mixup_alpha, cutmix_alpha, switch_prob,
                                   mixup_prob)
    y0, y1, x0, x1 = _cutmix_boxes(rng, img_h, img_w, lam0, cutmix_minmax)
    if mode == "pair":
        def mirror(a):
            return np.concatenate([a, a[::-1]])
        lam0, use_cutmix, y0, y1, x0, x1 = map(mirror, (lam0, use_cutmix, y0, y1, x0, x1))
    return MixupDraws(lam0, use_cutmix, y0, y1, x0, x1)


def _check_mode(mode: str, batch: int, cutmix_minmax) -> None:
    if mode not in MIXUP_MODES:
        raise ValueError(f"unknown mixup mode {mode!r}")
    if mode == "pair" and batch % 2:
        raise ValueError("pair mode needs an even batch (timm asserts this)")
    if cutmix_minmax is not None and len(cutmix_minmax) != 2:
        raise ValueError("cutmix_minmax must be (lo, hi)")


def _realized_lam(draws: MixupDraws, img_h: int, img_w: int) -> np.ndarray:
    """Each draw's mixing weight (float32): ``lam0`` for a mixup draw or one
    not applied, else the share of the image the box leaves,
    ``1 - area / (H * W)`` (timm's ``correct_lam``)."""
    f32 = np.float32
    area = ((np.asarray(draws.y1) - np.asarray(draws.y0))
            * (np.asarray(draws.x1) - np.asarray(draws.x0))).astype(np.float32)
    lam_cut = f32(1.0) - area / f32(img_h * img_w)
    lam0 = np.asarray(draws.lam0, np.float32)
    return np.where(np.asarray(draws.use_cutmix),
                    np.where(lam0 == f32(1.0), f32(1.0), lam_cut), lam0).astype(np.float32)


def mixup_cutmix(samples: torch.Tensor, labels: torch.Tensor, num_classes: int,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 switch_prob: float = 0.5, smoothing: float = 0.1,
                 mixup_prob: float = 1.0, mode: str = "batch", cutmix_minmax=None,
                 draws: Optional[MixupDraws] = None,
                 rng: Optional[np.random.Generator] = None):
    """timm ``Mixup`` on NHWC ``samples``: ``(mixed, targets (B, K))``.

    Modes: ``batch``, one weight and one mixup/CutMix choice for the whole
    batch; ``elem``, one per example; ``pair``, one per pair ``(i, B-1-i)``,
    both sides sharing weight and box. Without ``draws`` they come from
    ``rng`` (:func:`sample_mixup_draws`)."""
    b, img_h, img_w, _ = samples.shape
    _check_mode(mode, b, cutmix_minmax)
    if draws is None:
        if rng is None:
            raise ValueError("mixup_cutmix needs draws or an rng")
        draws = sample_mixup_draws(rng, b, img_h, img_w, mixup_alpha, cutmix_alpha,
                                   switch_prob, mixup_prob, mode, cutmix_minmax)
    dev = samples.device
    lam = _realized_lam(draws, img_h, img_w)
    flipped = samples.flip(0)
    if mode == "batch":
        if bool(draws.use_cutmix):
            if float(draws.lam0) == 1.0:
                mixed = samples
            else:
                iy = torch.arange(img_h, device=dev).view(-1, 1)
                ix = torch.arange(img_w, device=dev).view(1, -1)
                box = ((iy >= int(draws.y0)) & (iy < int(draws.y1))
                       & (ix >= int(draws.x0)) & (ix < int(draws.x1)))
                mixed = torch.where(box[None, :, :, None], flipped, samples)
        else:
            mixed = samples * float(lam) + flipped * float(np.float32(1.0) - lam)
        lam_t = float(lam)
    else:
        def col(a, dtype):
            return torch.as_tensor(np.array(a), dtype=dtype, device=dev).view(b, 1, 1)

        iy = torch.arange(img_h, device=dev).view(1, -1, 1)
        ix = torch.arange(img_w, device=dev).view(1, 1, -1)
        use_cut = col(draws.use_cutmix, torch.bool)
        active = use_cut & col(np.asarray(draws.lam0, np.float32) != 1.0, torch.bool)
        box = ((iy >= col(draws.y0, torch.long)) & (iy < col(draws.y1, torch.long))
               & (ix >= col(draws.x0, torch.long)) & (ix < col(draws.x1, torch.long)))
        mixed_cut = torch.where((box & active)[..., None], flipped, samples)
        lam_col = col(lam, torch.float32)[..., None]
        mixed_mix = samples * lam_col + flipped * col(np.float32(1.0) - lam,
                                                      torch.float32)[..., None]
        mixed = torch.where(use_cut[..., None], mixed_cut, mixed_mix)
        lam_t = torch.as_tensor(lam, device=dev).view(b, 1)

    y = one_hot_smooth(labels, num_classes, smoothing)
    targets = y * lam_t + y.flip(0) * (1.0 - lam_t)
    return mixed, targets
