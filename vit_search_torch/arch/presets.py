"""Canonical ``network_def`` presets.

All architectures published by the reference — supernet "largest" networks,
the hand-designed ViT-Res reference nets, and the searched ViT-ResNAS
winners — extracted from the reference experiment scripts
(reference: scripts/vit-sr-nas/**/*.sh) and cost-model self-tests
(network_utils/compute_flop_mac.py:310-459).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .network_def import (CONV_EMBED, FLEX_CONV_EMBED, LINEAR_EMBED,
                          NetworkDef, SPATIAL_REDUCTION)


def transformer_stage(embed: int, heads: int, head_dim: int, ffn: int, depth: int) -> Tuple:
    """``depth`` identical transformer blocks."""
    return tuple((1, (embed, heads, head_dim), (embed, ffn), 1) for _ in range(depth))


def multi_stage_def(stem: tuple, stages: Sequence[Tuple[int, int, int, int, int]],
                    num_classes: int = 1000) -> NetworkDef:
    """Build an SR network: ``stages`` are (embed, heads, head_dim, ffn, depth)."""
    blocks = [stem]
    prev_embed: Optional[int] = None
    for embed, heads, head_dim, ffn, depth in stages:
        if prev_embed is not None:
            blocks.append((SPATIAL_REDUCTION, prev_embed, embed))
        blocks.extend(transformer_stage(embed, heads, head_dim, ffn, depth))
        prev_embed = embed
    blocks.append((2, prev_embed, num_classes))
    return tuple(blocks)


def flat_vit_def(embed: int, heads: int, head_dim: int, ffn: int, depth: int,
                 num_classes: int = 1000) -> NetworkDef:
    """Plain single-stage ViT (DeiT-style)."""
    return ((LINEAR_EMBED, embed),) + transformer_stage(embed, heads, head_dim, ffn, depth) \
        + ((2, embed, num_classes),)


# --- DeiT-style flat ViTs (cost-model goldens; compute_flop_mac.py:317-391) ---

VIT_TINY = flat_vit_def(192, 3, 64, 768, 12)
VIT_SMALL = flat_vit_def(384, 6, 64, 1536, 12)
VIT_BASE = flat_vit_def(768, 12, 64, 3072, 12)

# --- Hand-designed reference net (scripts/vit-sr-nas/reference_net/tiny.sh) ---

VIT_RES_TINY = multi_stage_def(
    (CONV_EMBED, 192),
    [(192, 3, 64, 768, 4), (384, 6, 64, 1536, 4), (768, 12, 64, 3072, 4)],
)

# --- Supernet "largest" networks (per search space) ----------------------------

# sr_tiny space largest (supernet_config/sr_tiny.py docstring; 7/7/4 blocks)
SUPERNET_SR_TINY = multi_stage_def(
    (LINEAR_EMBED, 256),
    [(256, 4, 64, 768, 7), (512, 8, 64, 1536, 7), (1024, 12, 64, 3072, 4)],
)

# sr_tiny_666 space largest (super_net/no_distill/tiny.sh)
SUPERNET_SR_TINY_666 = multi_stage_def(
    (LINEAR_EMBED, 256),
    [(256, 4, 64, 768, 6), (512, 8, 64, 1536, 6), (1024, 12, 64, 3072, 6)],
)

# sr_tiny_mh space largest, conv patch stem (super_net/tiny.sh — ViT-ResNAS-Tiny supernet)
SUPERNET_SR_TINY_MH = multi_stage_def(
    (CONV_EMBED, 256),
    [(256, 6, 32, 768, 6), (512, 12, 48, 1536, 6), (1024, 12, 64, 3072, 6)],
)

# sr_small space largest, flexible conv stem (super_net/no_distill/small_flexible-conv-patch.sh)
SUPERNET_SR_SMALL_FLEX = multi_stage_def(
    (FLEX_CONV_EMBED, 320, 32),
    [(320, 8, 32, 960, 7), (640, 12, 48, 1920, 7), (1280, 12, 64, 3840, 7)],
)

# sr_small_mh space largest (super_net/small.sh — ViT-ResNAS-Small/Medium supernet)
SUPERNET_SR_SMALL_MH = multi_stage_def(
    (CONV_EMBED, 320),
    [(320, 8, 32, 960, 7), (640, 16, 48, 1920, 7), (1280, 16, 64, 3840, 7)],
)

# --- Searched winners (scripts/vit-sr-nas/searched_net/*.sh) --------------------

VIT_RESNAS_TINY = (
    (4, 176),
    (1, (176, 3, 32), (176, 704), 1), (1, (176, 3, 32), (176, 576), 1),
    (1, (176, 3, 32), (176, 640), 1), (1, (176, 4, 32), (176, 576), 1),
    (1, (176, 4, 32), (176, 704), 1),
    (3, 176, 352),
    (1, (352, 10, 48), (352, 1408), 1), (1, (352, 8, 48), (352, 1408), 1),
    (1, (352, 8, 48), (352, 1280), 1), (1, (352, 8, 48), (352, 1408), 1),
    (1, (352, 10, 48), (352, 1280), 1), (1, (352, 10, 48), (352, 1024), 1),
    (3, 352, 704),
    (1, (704, 10, 64), (704, 2560), 1), (1, (704, 10, 64), (704, 1792), 1),
    (1, (704, 10, 64), (704, 2816), 1), (1, (704, 8, 64), (704, 2816), 1),
    (1, (704, 8, 64), (704, 2560), 1),
    (2, 704, 1000),
)

VIT_RESNAS_SMALL = (
    (4, 220),
    (1, (220, 5, 32), (220, 880), 1), (1, (220, 5, 32), (220, 880), 1),
    (1, (220, 7, 32), (220, 800), 1), (1, (220, 5, 32), (220, 720), 1),
    (1, (220, 5, 32), (220, 720), 1), (1, (220, 5, 32), (220, 720), 1),
    (3, 220, 440),
    (1, (440, 10, 48), (440, 1760), 1), (1, (440, 10, 48), (440, 1440), 1),
    (1, (440, 10, 48), (440, 1920), 1), (1, (440, 10, 48), (440, 1600), 1),
    (1, (440, 12, 48), (440, 1600), 1), (1, (440, 12, 48), (440, 1440), 1),
    (3, 440, 880),
    (1, (880, 16, 64), (880, 3200), 1), (1, (880, 12, 64), (880, 3200), 1),
    (1, (880, 16, 64), (880, 2880), 1), (1, (880, 12, 64), (880, 2240), 1),
    (1, (880, 14, 64), (880, 2560), 1),
    (2, 880, 1000),
)

VIT_RESNAS_MEDIUM = (
    (4, 240),
    (1, (240, 7, 32), (240, 960), 1), (1, (240, 6, 32), (240, 960), 1),
    (1, (240, 7, 32), (240, 800), 1), (1, (240, 8, 32), (240, 960), 1),
    (1, (240, 7, 32), (240, 880), 1), (1, (240, 8, 32), (240, 880), 1),
    (1, (240, 6, 32), (240, 800), 1),
    (3, 240, 640),
    (1, (640, 10, 48), (640, 1120), 1), (1, (640, 14, 48), (640, 1760), 1),
    (1, (640, 14, 48), (640, 1920), 1), (1, (640, 16, 48), (640, 1760), 1),
    (1, (640, 14, 48), (640, 1440), 1), (1, (640, 16, 48), (640, 1760), 1),
    (1, (640, 16, 48), (640, 1920), 1),
    (3, 640, 880),
    (1, (880, 16, 64), (880, 3200), 1), (1, (880, 10, 64), (880, 3840), 1),
    (1, (880, 16, 64), (880, 3840), 1), (1, (880, 12, 64), (880, 3200), 1),
    (1, (880, 16, 64), (880, 3520), 1), (1, (880, 14, 64), (880, 3520), 1),
    (2, 880, 1000),
)

PRESETS = {
    "vit_tiny": VIT_TINY,
    "vit_small": VIT_SMALL,
    "vit_base": VIT_BASE,
    "vit_res_tiny": VIT_RES_TINY,
    "supernet_sr_tiny": SUPERNET_SR_TINY,
    "supernet_sr_tiny_666": SUPERNET_SR_TINY_666,
    "supernet_sr_tiny_mh": SUPERNET_SR_TINY_MH,
    "supernet_sr_small_flex": SUPERNET_SR_SMALL_FLEX,
    "supernet_sr_small_mh": SUPERNET_SR_SMALL_MH,
    "vit_resnas_tiny": VIT_RESNAS_TINY,
    "vit_resnas_small": VIT_RESNAS_SMALL,
    "vit_resnas_medium": VIT_RESNAS_MEDIUM,
}
