"""network_def generators for evolutionary search.

A numpy copy of the JAX package's ``search/generators.py``, so the port
imports nothing of it.

Random sampling, mutation and crossover over a search space, all
rejection-sampled into the resource band ``[0.975 * constraint, constraint]``.
Semantics match the reference generators (search_utils/gen_utils.py:111-383):

- widths only move *down* the sorted candidate lists when pruning,
- embed/SR width changes propagate via :func:`~...arch.network_def.update_embed_size`,
- block removals cascade via :func:`~...arch.network_def.update_depth`,
- :func:`reduce_constraint` prunes heads/FFN first and only touches embedding
  widths / whole blocks after 100 failed attempts.

All randomness flows through an explicit ``numpy.random.Generator`` — the
reference mutates the *global* numpy RNG, which is hostile to reproducible
multi-host search; seeded generators give deterministic populations per rank.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..arch import network_def as nd

RESOURCE_LOWER_BOUND = 0.975  # same band as the reference (gen_utils.py:53)

ResourceFn = Callable[[Sequence], float]


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


def _prune_to_next(choices: np.ndarray, current: int) -> int:
    """First candidate strictly below ``current`` (choices sorted descending)."""
    for c in choices:
        if int(c) < current:
            return int(c)
    return current


def prune_random_one(network_def: List, space: Sequence, *, prune_embed: bool = True,
                     prune_block: bool = True, rng: Optional[np.random.Generator] = None) -> List:
    """Shrink one uniformly-chosen block to its next-smaller option.

    Reference: search_utils/gen_utils.py:111-176.
    """
    r = _rng(rng)
    network_def = copy.deepcopy(network_def)
    num_blocks = len(network_def) - 1  # never the head

    start_idx = 0 if prune_embed else 1
    block_idx = int(r.integers(start_idx, num_blocks))
    if not prune_embed:
        while nd.block_type(network_def[block_idx]) != nd.TRANSFORMER:
            block_idx = int(r.integers(start_idx, num_blocks))

    block = network_def[block_idx]
    keep = space[block_idx]
    btype = nd.block_type(block)

    if btype in nd.EMBED_TYPES:
        block[1] = _prune_to_next(keep, block[1])
        nd.update_embed_size(network_def)
    elif btype == nd.TRANSFORMER:
        n_options = 3 if (keep["layer"] is not None and prune_block) else 2
        choice = int(r.integers(n_options))
        if choice == 0:    # attention heads
            head_dim = block[1][2]
            heads = [int(c) // head_dim for c in keep["attn"]]
            block[1][1] = _prune_to_next(np.array(heads), block[1][1])
        elif choice == 1:  # ffn hidden
            block[2][1] = _prune_to_next(keep["mlp"], block[2][1])
        else:              # drop the whole block
            if int(r.choice(keep["layer"])) == 0:
                block[3] = 0
                nd.update_depth(network_def, space)
    elif btype == nd.SPATIAL_REDUCTION:
        pruned = _prune_to_next(keep, block[2])
        if pruned != block[2]:
            block[2] = pruned
            nd.update_embed_size(network_def)
    else:
        raise ValueError(f"cannot prune block type {btype}")
    return network_def


def reduce_constraint(network_def: Sequence, space: Sequence, constraint: float,
                      compute_resource: ResourceFn, *,
                      rng: Optional[np.random.Generator] = None) -> List:
    """Prune until the resource fits under ``constraint``.

    Heads/FFN first; embedding widths and block removal only after 100
    attempts (reference: search_utils/gen_utils.py:179-204).
    """
    r = _rng(rng)
    threshold = 100
    net = nd.to_mutable(network_def)
    tries = 0
    while compute_resource(net) > constraint:
        aggressive = tries >= threshold
        net = prune_random_one(net, space, prune_embed=aggressive,
                               prune_block=aggressive, rng=r)
        tries += 1
    return net


def random_sample_embed_depth(largest: Sequence, space: Sequence, *,
                              rng: Optional[np.random.Generator] = None) -> List:
    """Uniformly sample embed/SR widths and block existence.

    Reference: search_utils/gen_utils.py:207-231.
    """
    r = _rng(rng)
    net = nd.to_mutable(largest)
    for i, block in enumerate(net):
        keep = space[i]
        btype = nd.block_type(block)
        if btype in nd.EMBED_TYPES:
            block[1] = int(r.choice(keep))
            nd.update_embed_size(net)
        elif btype == nd.TRANSFORMER:
            if keep["layer"] is not None and int(r.choice(keep["layer"])) == 0:
                block[3] = 0
        elif btype == nd.SPATIAL_REDUCTION:
            block[2] = int(r.choice(keep))
            nd.update_embed_size(net)
    nd.update_depth(net, space)
    return net


def gen_random_network_def(largest: Sequence, space: Sequence, constraint: float,
                           compute_resource: ResourceFn, *,
                           rng: Optional[np.random.Generator] = None) -> nd.NetworkDef:
    """Rejection-sample a random candidate into the resource band.

    Reference: search_utils/gen_utils.py:234-252.
    """
    r = _rng(rng)
    lo = RESOURCE_LOWER_BOUND * constraint
    while True:
        net = random_sample_embed_depth(largest, space, rng=r)
        while compute_resource(net) < lo:
            net = random_sample_embed_depth(largest, space, rng=r)
        net = reduce_constraint(net, space, constraint, compute_resource, rng=r)
        resource = compute_resource(net)
        if lo <= resource <= constraint:
            return nd.to_immutable(net)


def _mutate_once(parent: Sequence, space: Sequence, m_prob: float,
                 r: np.random.Generator) -> List:
    net = nd.to_mutable(parent)
    for i, block in enumerate(net):
        keep = space[i]
        btype = nd.block_type(block)
        if btype in nd.EMBED_TYPES:
            if r.uniform() <= m_prob:
                block[1] = int(r.choice(keep))
                nd.update_embed_size(net)
        elif btype == nd.TRANSFORMER:
            if r.uniform() <= m_prob:
                block[1][1] = int(r.choice(keep["attn"])) // block[1][2]
            if r.uniform() <= m_prob:
                block[2][1] = int(r.choice(keep["mlp"]))
            if keep["layer"] is not None and r.uniform() <= m_prob:
                block[3] = 0 if block[3] else 1  # flip existence
                nd.update_depth(net, space)
        elif btype == nd.SPATIAL_REDUCTION:
            if r.uniform() <= m_prob:
                block[2] = int(r.choice(keep))
                nd.update_embed_size(net)
        elif btype == nd.HEAD:
            pass
        else:
            raise ValueError(f"unexpected block type {btype}")
    return net


def mutate_network_def(parent: Sequence, space: Sequence, m_prob: float,
                       constraint: float, compute_resource: ResourceFn, *,
                       rng: Optional[np.random.Generator] = None) -> nd.NetworkDef:
    """Mutate each dimension with prob ``m_prob``; rejection-sample into band.

    Reference: search_utils/gen_utils.py:255-323.
    """
    r = _rng(rng)
    lo = RESOURCE_LOWER_BOUND * constraint
    while True:
        net = _mutate_once(parent, space, m_prob, r)
        if lo <= compute_resource(net) <= constraint:
            return nd.to_immutable(net)


def _crossover_once(m_parent: Sequence, f_parent: Sequence, space: Sequence,
                    r: np.random.Generator) -> List:
    net = nd.to_mutable(m_parent)
    for i, block in enumerate(net):
        btype = nd.block_type(block)
        if btype in nd.EMBED_TYPES:
            if r.uniform() <= 0.5:
                block[1] = f_parent[i][1]
                nd.update_embed_size(net)
        elif btype == nd.TRANSFORMER:
            if r.uniform() <= 0.5:
                block[1][1] = f_parent[i][1][1]
            if r.uniform() <= 0.5:
                block[2][1] = f_parent[i][2][1]
            if r.uniform() <= 0.5:
                block[3] = f_parent[i][3]
                nd.update_depth(net, space)
        elif btype == nd.SPATIAL_REDUCTION:
            if r.uniform() <= 0.5:
                block[2] = f_parent[i][2]
                nd.update_embed_size(net)
        elif btype == nd.HEAD:
            pass
        else:
            raise ValueError(f"unexpected block type {btype}")
    return net


def crossover_network_def(m_parent: Sequence, f_parent: Sequence, space: Sequence,
                          constraint: float, compute_resource: ResourceFn, *,
                          rng: Optional[np.random.Generator] = None) -> nd.NetworkDef:
    """Uniform crossover of two parents; rejection-sampled into band.

    Reference: search_utils/gen_utils.py:326-383.
    """
    r = _rng(rng)
    lo = RESOURCE_LOWER_BOUND * constraint
    while True:
        net = _crossover_once(m_parent, f_parent, space, r)
        if lo <= compute_resource(net) <= constraint:
            return nd.to_immutable(net)
