"""Device-side data augmentation of the port (token mixup)."""

from .mixup import (ImageMixDraws, PatchMixDraws, TokenMixDraws, image_mixup,
                    one_hot_smooth, patch_mixup, sample_token_mix_draws,
                    switch_token_mix)

__all__ = [
    "ImageMixDraws",
    "PatchMixDraws",
    "TokenMixDraws",
    "image_mixup",
    "one_hot_smooth",
    "patch_mixup",
    "sample_token_mix_draws",
    "switch_token_mix",
]
