"""Device-side data augmentation of the port (token mixup, random erasing)."""

from .erasing import ErasingDraws, random_erasing, sample_erasing_draws
from .mixup import (ImageMixDraws, PatchMixDraws, TokenMixDraws, image_mixup,
                    one_hot_smooth, patch_mixup, sample_token_mix_draws,
                    switch_token_mix)

__all__ = [
    "ErasingDraws",
    "ImageMixDraws",
    "PatchMixDraws",
    "TokenMixDraws",
    "image_mixup",
    "one_hot_smooth",
    "patch_mixup",
    "random_erasing",
    "sample_erasing_draws",
    "sample_token_mix_draws",
    "switch_token_mix",
]
