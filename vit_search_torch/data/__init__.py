"""Device-side data augmentation of the port (token mixup, mixup/CutMix,
random erasing)."""

from .erasing import ErasingDraws, random_erasing, sample_erasing_draws
from .mixup import (ImageMixDraws, MixupDraws, PatchMixDraws, TokenMixDraws, image_mixup,
                    mixup_cutmix, one_hot_smooth, patch_mixup, sample_mixup_draws,
                    sample_token_mix_draws, switch_token_mix)

__all__ = [
    "ErasingDraws",
    "ImageMixDraws",
    "MixupDraws",
    "PatchMixDraws",
    "TokenMixDraws",
    "image_mixup",
    "mixup_cutmix",
    "one_hot_smooth",
    "patch_mixup",
    "random_erasing",
    "sample_erasing_draws",
    "sample_mixup_draws",
    "sample_token_mix_draws",
    "switch_token_mix",
]
