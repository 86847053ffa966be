"""Models of the port: masked ViT-SR blocks, stems, supernet sampling, the
RegNetY teacher."""

from .layers import Attention, Block, MaskedLayerNorm, Mlp
from .patch_embed import BatchNorm, ConvBnAct, PatchConvEmbed, PatchEmbed
from .regnet import RegNetY, RegNetYUpsample, resize_images
from .registry import available_models, create_model, is_supernet_model
from .supernet import SupernetSchedules, build_arch_masks
from .surgery import interpolate_pos_embeds, rewire_params, slice_subnet_params
from .vit_sr import SpatialReductionPatchEmbed, VisionTransformerSR

__all__ = [
    "Attention",
    "BatchNorm",
    "Block",
    "ConvBnAct",
    "MaskedLayerNorm",
    "Mlp",
    "PatchConvEmbed",
    "PatchEmbed",
    "RegNetY",
    "RegNetYUpsample",
    "SpatialReductionPatchEmbed",
    "SupernetSchedules",
    "VisionTransformerSR",
    "available_models",
    "build_arch_masks",
    "create_model",
    "interpolate_pos_embeds",
    "is_supernet_model",
    "resize_images",
    "rewire_params",
    "slice_subnet_params",
]
