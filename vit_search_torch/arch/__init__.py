"""Architecture IR, search spaces and canonical presets (numpy only).

A copy of the JAX package's ``arch`` modules, so the port imports nothing of
it. The cost model waits for a later slice.
"""

from . import network_def, presets, spaces
from .network_def import (NetworkDef, format_network_def, parse_network_def,
                          to_immutable, to_mutable, update_depth,
                          update_embed_size, validate)
from .presets import PRESETS
from .spaces import available_spaces, get_space

__all__ = [
    "NetworkDef",
    "PRESETS",
    "available_spaces",
    "format_network_def",
    "get_space",
    "network_def",
    "parse_network_def",
    "presets",
    "spaces",
    "to_immutable",
    "to_mutable",
    "update_depth",
    "update_embed_size",
    "validate",
]
