"""Input pipeline of the port: datasets, host transforms, samplers and
loaders (numpy and PIL, copies of the JAX package's), the device feed, and
the device-side augmentation (token mixup, mixup/CutMix, random erasing)."""

from . import datasets, erasing, feed, loader, mixup, samplers, subset, transforms
from .datasets import (CIFAR100Dataset, ImageFolderDataset, INatDataset, SyntheticDataset,
                       build_dataset)
from .erasing import ErasingDraws, random_erasing, sample_erasing_draws
from .feed import prefetch_to_device
from .loader import DataLoader, PaddedEvalLoader
from .mixup import (ImageMixDraws, MixupDraws, PatchMixDraws, TokenMixDraws, image_mixup,
                    mixup_cutmix, one_hot_smooth, patch_mixup, sample_mixup_draws,
                    sample_token_mix_draws, switch_token_mix)
from .samplers import RepeatedAugmentSampler, ShardedSampler
from .subset import build_subsets, convert_reference_pickle, select_holdout
from .transforms import (IMAGENET_MEAN, IMAGENET_STD, EvalTransform, RandAugment,
                         TrainTransform)

__all__ = [
    "CIFAR100Dataset",
    "DataLoader",
    "ErasingDraws",
    "EvalTransform",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "INatDataset",
    "ImageFolderDataset",
    "ImageMixDraws",
    "MixupDraws",
    "PaddedEvalLoader",
    "PatchMixDraws",
    "RandAugment",
    "RepeatedAugmentSampler",
    "ShardedSampler",
    "SyntheticDataset",
    "TokenMixDraws",
    "TrainTransform",
    "build_dataset",
    "build_subsets",
    "convert_reference_pickle",
    "datasets",
    "erasing",
    "feed",
    "image_mixup",
    "loader",
    "mixup",
    "mixup_cutmix",
    "one_hot_smooth",
    "patch_mixup",
    "prefetch_to_device",
    "random_erasing",
    "samplers",
    "sample_erasing_draws",
    "sample_mixup_draws",
    "sample_token_mix_draws",
    "select_holdout",
    "subset",
    "switch_token_mix",
    "transforms",
]
