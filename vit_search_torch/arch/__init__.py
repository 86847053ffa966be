"""Architecture IR, search spaces and canonical presets (numpy only).

A copy of the JAX package's ``arch`` modules, so the port imports nothing of
it.
"""

from . import cost, network_def, presets, spaces
from .cost import ComputationEstimator
from .network_def import (NetworkDef, format_network_def, parse_network_def,
                          to_immutable, to_mutable, update_depth,
                          update_embed_size, validate)
from .presets import PRESETS
from .spaces import available_spaces, get_space

__all__ = [
    "ComputationEstimator",
    "NetworkDef",
    "PRESETS",
    "available_spaces",
    "cost",
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
