"""Where a network's attention and masked layer norms run: the shapes and
counts of each call per forward, from its ``network_def`` alone."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

TRANSFORMER, SPATIAL_REDUCTION = 1, 3


def to_tuple(t):
    """Nested lists (a network_def read from JSON) as nested tuples."""
    return tuple(to_tuple(x) for x in t) if isinstance(t, (list, tuple)) else t


def stages(network_def: Sequence, resolution: int, patch_size: int = 14, tokens: int = 1):
    """Yield ``(slot, block, n, width)`` for every block after the stem, ``n``
    the sequence length and ``width`` the stage width where it runs."""
    grid = resolution // patch_size
    width = network_def[0][1]
    for slot, block in enumerate(network_def[1:-1], start=1):
        yield slot, block, grid * grid + tokens, width
        if block[0] == SPATIAL_REDUCTION:
            grid //= 2
            width = block[2]


def attention_calls(network_def: Sequence, resolution: int, batch: int
                    ) -> List[Tuple[Tuple[int, int, int, int], int]]:
    """``((B, N, H, D), calls)`` per forward, one call per existing block."""
    calls: Counter = Counter()
    for _, block, n, _ in stages(network_def, resolution):
        if block[0] == TRANSFORMER and block[3]:
            _, heads, head_dim = block[1]
            calls[(batch, n, heads, head_dim)] += 1
    return sorted(calls.items())


def masked_ln_calls(network_def: Sequence, space: Sequence, resolution: int, batch: int
                    ) -> List[Tuple[Tuple[int, int, int], Tuple[int, ...], int]]:
    """``((B, N, C), embed keep widths, calls)`` per forward of a supernet:
    two per block, one per spatial reduction (on its input), one final
    norm; each masked by its stage's embed mask."""
    calls: Dict = {}
    embed_widths = tuple(space[0])
    for slot, block, n, width in stages(network_def, resolution):
        if block[0] == TRANSFORMER and block[3]:
            calls.setdefault((batch, n, width), [embed_widths, 0])[1] += 2
        elif block[0] == SPATIAL_REDUCTION:
            calls.setdefault((batch, n, width), [embed_widths, 0])[1] += 1
            embed_widths = tuple(space[slot])
    grid = resolution // 14
    for block in network_def:
        grid //= 2 if block[0] == SPATIAL_REDUCTION else 1
    final = (batch, grid * grid + 1, network_def[-1][1])
    calls.setdefault(final, [embed_widths, 0])[1] += 1
    return sorted((k, tuple(w), c) for k, (w, c) in calls.items())
