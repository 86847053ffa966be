"""Model registry: name -> module factory (the timm ``create_model`` role).

Port of vit_search_tpu/models/registry.py, every name: the ViT-SR patch-14
nets (the six 224 px names and the 280/336/392 px patch-output nets the
finetune scripts train), the flexible flat ViTs (patch 16), the stock and
distilled DeiT nets, and the RegNetY-16GF teacher; and, not in the JAX
package, SwinV2-B (``swinv2_base_window16_256``) and EVA-02-L at 448 px
(``eva02_large_patch14_448``). ``*_supernet`` names
build the same module as their base name: supernet training is a property of
the masks fed at call time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from torch import nn

from ..arch import presets
from ..arch.presets import flat_vit_def
from .eva02 import EVA02
from .regnet import RegNetYUpsample
from .swin_v2 import SwinTransformerV2
from .vit_sr import VisionTransformerSR

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(fn: Callable[..., Any]) -> Callable[..., Any]:
    _REGISTRY[fn.__name__] = fn
    return fn


def is_supernet_model(name: str) -> bool:
    return name.endswith("_supernet")


def available_models() -> List[str]:
    return sorted(_REGISTRY)


def create_model(name: str, **kwargs) -> nn.Module:
    """Instantiate a registered model on the CUDA device (``device="cpu"``
    to build it on the CPU). Keyword arguments go to
    :class:`VisionTransformerSR` (``gelu``, ``ln_route``, ``dtype``, ...),
    to :class:`RegNetYUpsample` for the teacher, to
    :class:`SwinTransformerV2` or to :class:`EVA02`."""
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


# --- flexible flat ViTs (patch 16) ---------------------------------------------

def _vit_flat(default_img_size: int, **kwargs):
    kwargs.setdefault("img_size", default_img_size)
    kwargs.setdefault("network_def", presets.VIT_TINY)
    kwargs.setdefault("num_classes", kwargs["network_def"][-1][2])
    # unlike the ViT-SR names, a flat ViT carries a distill token by default
    return VisionTransformerSR(patch_size=16, distill_token=kwargs.pop("distill_token", True),
                               patch_output=False, **kwargs)


@register_model
def flexible_vit_patch16_224(**kwargs):
    return _vit_flat(224, **kwargs)


@register_model
def flexible_vit_patch16_224_supernet(**kwargs):
    return _vit_flat(224, **kwargs)


@register_model
def flexible_vit_patch16_192(**kwargs):
    return _vit_flat(192, **kwargs)


@register_model
def flexible_vit_patch16_192_supernet(**kwargs):
    return _vit_flat(192, **kwargs)


# --- stock DeiT and the distilled variants ---------------------------------------

def _deit(embed_dim: int, num_heads: int, distill_token: bool, **kwargs):
    """A flat DeiT net of ``depth`` (default 12) blocks, head dim
    ``embed_dim // num_heads``, MLP 4x; a ``network_def`` given is dropped."""
    depth = kwargs.pop("depth", 12)
    kwargs.pop("network_def", None)
    net = flat_vit_def(embed_dim, num_heads, embed_dim // num_heads, embed_dim * 4, depth,
                       num_classes=kwargs.get("num_classes", 1000))
    return VisionTransformerSR(network_def=net, img_size=kwargs.pop("img_size", 224),
                               patch_size=16, distill_token=distill_token, **kwargs)


@register_model
def deit_tiny_patch16_224(**kwargs):
    return _deit(192, 3, distill_token=False, **kwargs)


@register_model
def deit_small_patch16_224(**kwargs):
    return _deit(384, 6, distill_token=False, **kwargs)


@register_model
def deit_base_patch16_224(**kwargs):
    return _deit(768, 12, distill_token=False, **kwargs)


@register_model
def deit_tiny_distill_patch16_224(**kwargs):
    return _deit(192, 3, distill_token=True, **kwargs)


@register_model
def deit_tiny_133X_distill_patch16_224(**kwargs):
    return _deit(256, 4, distill_token=True, **kwargs)


@register_model
def deit_tiny_167X_distill_patch16_224(**kwargs):
    return _deit(320, 5, distill_token=True, **kwargs)


@register_model
def deit_small_distill_patch16_224(**kwargs):
    return _deit(384, 6, distill_token=True, **kwargs)


# --- SwinV2 ----------------------------------------------------------------------

@register_model
def swinv2_base_window16_256(**kwargs):
    """SwinV2-B at 256 px, window 16 (``swinv2_base_patch4_window16_256.yaml``):
    embed 128, depths 2 / 2 / 18 / 2, heads 4 / 8 / 16 / 32; ``embed_dim``,
    ``depths``, ``num_heads``, ``window_size`` and ``img_size`` may be given."""
    if kwargs.pop("network_def", None) is not None:
        raise ValueError("SwinV2 is not built from a network_def")
    kwargs.setdefault("drop_path_rate", 0.5)
    return SwinTransformerV2(**kwargs)


# --- EVA-02 ----------------------------------------------------------------------

@register_model
def eva02_large_patch14_448(**kwargs):
    """EVA-02-L fine-tuned at 448 px (``eva02_large_patch14_xattn_fusedLN_
    NaiveSwiGLU_subln_RoPE``): patch 14, embed 1024, 24 blocks, 16 heads of
    64, SwiGLU hidden ``int(1024 * 4 * 2 / 3)`` = 2730; ``img_size``,
    ``depth``, ``embed_dim``, ``num_heads`` and ``mlp_ratio`` may be given."""
    if kwargs.pop("network_def", None) is not None:
        raise ValueError("EVA-02 is not built from a network_def")
    kwargs.setdefault("img_size", 448)
    return EVA02(patch_size=14, **kwargs)


# --- teacher ---------------------------------------------------------------------

@register_model
def regnety_160_upsample(**kwargs):
    return RegNetYUpsample(**kwargs)
