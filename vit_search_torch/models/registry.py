"""Model registry: name -> module factory (the timm ``create_model`` role).

Port of the ViT-SR patch-14 names of vit_search_tpu/models/registry.py: the
six 224 px names and the 280/336/392 px patch-output nets the finetune scripts
train. ``*_supernet`` names build the same module as their base name: supernet
training is a property of the masks fed at call time. The other names (flat
ViTs, DeiT, the RegNet teacher) wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from ..arch import presets
from .vit_sr import VisionTransformerSR

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(fn: Callable[..., Any]) -> Callable[..., Any]:
    _REGISTRY[fn.__name__] = fn
    return fn


def is_supernet_model(name: str) -> bool:
    return name.endswith("_supernet")


def available_models() -> List[str]:
    return sorted(_REGISTRY)


def create_model(name: str, **kwargs) -> VisionTransformerSR:
    """Instantiate a registered model on the CUDA device (``device="cpu"``
    to build it on the CPU). Keyword arguments go to
    :class:`VisionTransformerSR` (``gelu``, ``ln_route``, ``dtype``, ...)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {available_models()}") from None
    return factory(**kwargs)


def _vit_sr(default_img_size: int, distill_token: bool, patch_output: bool, **kwargs):
    kwargs.setdefault("img_size", default_img_size)
    kwargs.setdefault("network_def", presets.VIT_RES_TINY)
    kwargs.setdefault("num_classes", kwargs["network_def"][-1][2])
    return VisionTransformerSR(patch_size=14, distill_token=distill_token,
                               patch_output=patch_output, **kwargs)


@register_model
def flexible_vit_sr_distill_patch14_224(**kwargs):
    return _vit_sr(224, distill_token=True, patch_output=False, **kwargs)


@register_model
def flexible_vit_sr_patch14_224(**kwargs):
    return _vit_sr(224, distill_token=False, patch_output=False, **kwargs)


@register_model
def flexible_vit_sr_patch14_224_patch_output(**kwargs):
    return _vit_sr(224, distill_token=False, patch_output=True, **kwargs)


@register_model
def flexible_vit_sr_distill_patch14_224_supernet(**kwargs):
    return _vit_sr(224, distill_token=True, patch_output=False, **kwargs)


@register_model
def flexible_vit_sr_patch14_224_supernet(**kwargs):
    return _vit_sr(224, distill_token=False, patch_output=False, **kwargs)


@register_model
def flexible_vit_sr_patch14_224_patch_output_supernet(**kwargs):
    return _vit_sr(224, distill_token=False, patch_output=True, **kwargs)


@register_model
def flexible_vit_sr_patch14_280_patch_output(**kwargs):
    return _vit_sr(280, distill_token=False, patch_output=True, **kwargs)


@register_model
def flexible_vit_sr_patch14_336_patch_output(**kwargs):
    return _vit_sr(336, distill_token=False, patch_output=True, **kwargs)


@register_model
def flexible_vit_sr_patch14_392_patch_output(**kwargs):
    return _vit_sr(392, distill_token=False, patch_output=True, **kwargs)
