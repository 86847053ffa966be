"""Ops of the port: masking, stochastic depth, masked layer norm, row
statistics, attention.

Import the modules themselves (``from vit_search_torch.ops import
masked_layer_norm``); each kernel's wrapper, counter and plain version live
in its module.
"""
