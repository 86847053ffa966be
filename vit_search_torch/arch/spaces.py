"""Search-space definitions ("supernet configs").

A search space is a list ``num_channels_to_keep`` aligned 1:1 with the blocks
of the largest ``network_def``:

- embedding / SR blocks  -> ``np.ndarray`` of candidate widths (descending),
- transformer blocks     -> ``{'attn': widths, 'mlp': widths, 'layer': widths|None}``
  where ``'attn'`` holds total attention widths (heads * head_dim), and a 0 in
  ``'layer'`` makes the whole block removable,
- the classifier head    -> ``None``.

The eight spaces match the reference's ``supernet_config`` package
(reference: supernet_config/{sr_tiny,sr_tiny_666,sr_tiny_mh,sr_small,
sr_small_mh,tiny,tiny_deep,small_deep}.py) entry for entry; spaces are looked
up by name exactly like the reference's ``getattr(supernet_config,
args.search_space)`` (main.py:344-346).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

SearchSpace = List  # list of np.ndarray | dict | None


def _blk(attn: Sequence[int], mlp: Sequence[int], layer: Optional[Sequence[int]] = None) -> Dict:
    return {
        "attn": np.array(attn),
        "mlp": np.array(mlp),
        "layer": None if layer is None else np.array(layer),
    }


def _space_sr(embeds, attns, mlps, skip_layers, stage_patterns) -> SearchSpace:
    """Build a 3-stage SR space.

    ``stage_patterns`` is a per-stage string of 'B' (fixed block) and
    'S' (removable block); embedding entries are inserted before each stage.
    """
    space: SearchSpace = []
    for embed, attn, mlp, skip, pattern in zip(embeds, attns, mlps, skip_layers, stage_patterns):
        space.append(np.array(embed))
        fixed = _blk(attn, mlp, None)
        removable = _blk(attn, mlp, skip)
        for ch in pattern.replace(" ", ""):
            space.append(copy.deepcopy(fixed if ch == "B" else removable))
    space.append(None)  # head
    return space


def _space_flat(embed, attn, mlp, skips, pattern) -> SearchSpace:
    """Build a single-stage (flat ViT) space.

    ``pattern`` uses 'B' for fixed blocks and digits to index into ``skips``.
    """
    space: SearchSpace = [np.array(embed)]
    fixed = _blk(attn, mlp, None)
    for ch in pattern.replace(" ", ""):
        if ch == "B":
            space.append(copy.deepcopy(fixed))
        else:
            space.append(_blk(attn, mlp, skips[int(ch)]))
    space.append(None)
    return space


# --- SR (multi-stage) spaces -------------------------------------------------

def sr_tiny() -> SearchSpace:
    return _space_sr(
        embeds=[[256, 224, 192, 176, 160], [512, 448, 384, 352, 320], [1024, 896, 768, 704, 640]],
        attns=[[256, 192, 128], [512, 384, 256], [768, 640, 512]],
        mlps=[[768, 640, 512, 384], [1536, 1280, 1024, 768], [3072, 2560, 2048, 1536]],
        skip_layers=[[256, 256, 256, 0], [512, 512, 512, 0], [1024, 1024, 1024, 0]],
        stage_patterns=["BSBSBSB", "BSBSBSB", "BBBB"],
    )


def sr_tiny_666() -> SearchSpace:
    return _space_sr(
        embeds=[[256, 224, 192, 176, 160], [512, 448, 384, 352, 320], [1024, 896, 768, 704, 640]],
        attns=[[256, 192, 128], [512, 384, 256], [768, 640, 512, 384]],
        mlps=[[768, 704, 640, 576, 512, 448, 384],
              [1536, 1408, 1280, 1152, 1024, 896, 768],
              [3072, 2816, 2560, 2304, 2048, 1792, 1536]],
        skip_layers=[[256, 256, 0, 0], [512, 512, 0, 0], [1024, 1024, 0, 0]],
        stage_patterns=["BSBSBS", "BSBSBS", "BSBSBS"],
    )


def sr_tiny_mh() -> SearchSpace:
    """Per-stage head_dim 32/48/64 ("multi-head") variant of sr_tiny_666."""
    return _space_sr(
        embeds=[[256, 224, 192, 176, 160], [512, 448, 384, 352, 320], [1024, 896, 768, 704, 640]],
        attns=[[192, 160, 128, 96], [576, 480, 384, 288], [768, 640, 512, 384]],
        mlps=[[768, 704, 640, 576, 512, 448, 384],
              [1536, 1408, 1280, 1152, 1024, 896, 768],
              [3072, 2816, 2560, 2304, 2048, 1792, 1536]],
        skip_layers=[[256, 256, 0, 0], [512, 512, 0, 0], [1024, 1024, 0, 0]],
        stage_patterns=["BSBSBS", "BSBSBS", "BSBSBS"],
    )


def sr_small() -> SearchSpace:
    return _space_sr(
        embeds=[[320, 280, 240, 220, 200], [640, 560, 480, 440, 400], [1280, 1120, 960, 880, 800]],
        attns=[[256, 224, 192, 160], [576, 480, 384, 288], [768, 640, 512, 384]],
        mlps=[[960, 880, 800, 720, 640, 560, 480],
              [1920, 1760, 1600, 1440, 1280, 1120, 960],
              [3840, 3520, 3200, 2880, 2560, 2240, 1920]],
        skip_layers=[[320, 320, 0, 0], [640, 640, 0, 0], [1280, 1280, 0, 0]],
        stage_patterns=["BSBSBSB", "BSBSBSB", "BSBSBSB"],
    )


def sr_small_mh() -> SearchSpace:
    """sr_small with wider attention in stages 2/3 ("more heads")."""
    return _space_sr(
        embeds=[[320, 280, 240, 220, 200], [640, 560, 480, 440, 400], [1280, 1120, 960, 880, 800]],
        attns=[[256, 224, 192, 160], [768, 672, 576, 480], [1024, 896, 768, 640]],
        mlps=[[960, 880, 800, 720, 640, 560, 480],
              [1920, 1760, 1600, 1440, 1280, 1120, 960],
              [3840, 3520, 3200, 2880, 2560, 2240, 1920]],
        skip_layers=[[320, 320, 0, 0], [640, 640, 0, 0], [1280, 1280, 0, 0]],
        stage_patterns=["BSBSBSB", "BSBSBSB", "BSBSBSB"],
    )


# --- Flat (single-stage) spaces ------------------------------------------------

def tiny() -> SearchSpace:
    return _space_flat(
        embed=[240, 224, 208, 192],
        attn=[512, 384, 256, 128],
        mlp=[1024, 768, 512, 256],
        skips=[[240, 240, 0], [240, 0]],
        pattern="B" + "BB01" * 3 + "B",
    )


def tiny_deep() -> SearchSpace:
    return _space_flat(
        embed=[240, 224, 208, 192],
        attn=[384, 320, 256, 192],
        mlp=[960, 800, 640, 480],
        skips=[[240, 240, 240, 0]],
        pattern="BB" + "B0B0" * 3 + "BB",
    )


def small_deep() -> SearchSpace:
    return _space_flat(
        embed=[384, 352, 320, 288],
        attn=[512, 448, 384, 320],
        mlp=[1536, 1280, 1024, 768],
        skips=[[384, 384, 384, 0]],
        pattern="BB" + "B0B0" * 3 + "BB",
    )


_SPACES = {
    "sr_tiny": sr_tiny,
    "sr_tiny_666": sr_tiny_666,
    "sr_tiny_mh": sr_tiny_mh,
    "sr_small": sr_small,
    "sr_small_mh": sr_small_mh,
    "tiny": tiny,
    "tiny_deep": tiny_deep,
    "small_deep": small_deep,
}


def register_space(name: str, factory) -> None:
    """Register a custom search space (tests, user extensions)."""
    _SPACES[name] = factory


def available_spaces() -> List[str]:
    return sorted(_SPACES)


def get_space(name: str) -> SearchSpace:
    """Look up ``num_channels_to_keep`` by search-space name."""
    try:
        return _SPACES[name]()
    except KeyError:
        raise ValueError(f"unknown search space {name!r}; available: {available_spaces()}") from None
