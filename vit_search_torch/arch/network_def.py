"""The ``network_def`` architecture IR.

A ``network_def`` is an immutable nested tuple describing one (multi-stage)
vision transformer.  The wire format is identical to the reference framework's
CLI literal (reference: search_utils/gen_utils.py:1-19, README.md:157-163,
nets/vit_sr_supernet.py:19-47) so that every published architecture string and
experiment script keeps working:

    ((0, 256),                          # linear patch embedding, 256 channels
     (1, (256, 4, 64), (256, 768), 1),  # transformer: (embed, heads, head_dim),
                                        #              (embed, ffn_hidden), exists
     (3, 256, 512),                     # spatial-reduction block: in_ch, out_ch
     (1, (512, 8, 64), (512, 1536), 1),
     (2, 512, 1000))                    # classifier head: in_ch, num_classes

Block type tags:
    0: linear patch embedding            (0, embed_ch)
    1: transformer block                 (1, (embed, n_head, head_dim), (embed, ffn_hidden), exists)
    2: classifier head                   (2, in_ch, num_classes)
    3: spatial-reduction patch embedding (3, in_ch, out_ch)
    4: convolutional patch embedding     (4, embed_ch)
    5: flexible conv patch embedding     (5, embed_ch, conv_mid_ch)

On top of the raw tuples this module provides typed accessors, validation,
stage decomposition and the two IR-invariant-maintenance transforms used by
both the model builder and the evolutionary search operators:

- :func:`update_embed_size` — propagate stage embedding widths through the
  network after an embedding/SR width change
  (reference semantics: search_utils/gen_utils.py:64-80).
- :func:`update_depth` — cascade block removals: a removable block is removed
  when its predecessor removable block (with no fixed block in between) was
  removed (reference semantics: search_utils/gen_utils.py:83-108).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, List, Sequence, Tuple

# --- Block type tags (wire format) -----------------------------------------

LINEAR_EMBED = 0
TRANSFORMER = 1
HEAD = 2
SPATIAL_REDUCTION = 3
CONV_EMBED = 4
FLEX_CONV_EMBED = 5

EMBED_TYPES = (LINEAR_EMBED, CONV_EMBED, FLEX_CONV_EMBED)

NetworkDef = Tuple[tuple, ...]


# --- Typed views ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformerBlockDef:
    embed_dim: int
    num_heads: int
    head_dim: int
    ffn_hidden: int
    exists: bool

    @property
    def attn_width(self) -> int:
        return self.num_heads * self.head_dim

    def to_tuple(self) -> tuple:
        return (
            TRANSFORMER,
            (self.embed_dim, self.num_heads, self.head_dim),
            (self.embed_dim, self.ffn_hidden),
            int(self.exists),
        )


def block_type(block: Sequence) -> int:
    return int(block[0])


def is_transformer(block: Sequence) -> bool:
    return block_type(block) == TRANSFORMER


def transformer_def(block: Sequence) -> TransformerBlockDef:
    assert block_type(block) == TRANSFORMER
    (embed, heads, head_dim), (ffn_embed, ffn_hidden) = block[1], block[2]
    assert embed == ffn_embed, f"attn/ffn embed mismatch: {embed} vs {ffn_embed}"
    return TransformerBlockDef(int(embed), int(heads), int(head_dim), int(ffn_hidden), bool(block[3]))


def embed_channels(block: Sequence) -> int:
    assert block_type(block) in EMBED_TYPES
    return int(block[1])


def conv_mid_channels(block: Sequence) -> int:
    assert block_type(block) == FLEX_CONV_EMBED
    return int(block[2])


def sr_channels(block: Sequence) -> Tuple[int, int]:
    assert block_type(block) == SPATIAL_REDUCTION
    return int(block[1]), int(block[2])


def head_channels(block: Sequence) -> Tuple[int, int]:
    """Returns ``(in_channels, num_classes)``."""
    assert block_type(block) == HEAD
    return int(block[1]), int(block[2])


# --- Parsing / formatting ----------------------------------------------------


def parse_network_def(text: str) -> NetworkDef:
    """Parse a CLI literal into a network_def tuple.

    Matches the reference behaviour of ``ast.literal_eval`` on the
    ``--network-def`` flag (reference: main.py:325-328).
    """
    value = ast.literal_eval(text)
    return to_immutable(value)


def format_network_def(network_def: NetworkDef) -> str:
    return repr(to_immutable(network_def))


def to_mutable(t: Any) -> Any:
    """Deep-convert nested tuples to nested lists (for search mutation)."""
    if isinstance(t, (tuple, list)):
        return [to_mutable(x) for x in t]
    return t


def to_immutable(t: Any) -> Any:
    """Deep-convert nested lists to nested tuples (canonical form)."""
    if isinstance(t, (tuple, list)):
        return tuple(to_immutable(x) for x in t)
    return t


# --- Validation ---------------------------------------------------------------


def validate(network_def: Sequence) -> None:
    """Raise ``ValueError`` if the network_def violates IR invariants.

    Mirrors the construction-time asserts of the reference model builder
    (nets/vit_sr_supernet.py:218,253-256,293-294,314,336) but as one explicit
    pass usable without building a model.
    """
    if len(network_def) < 2:
        raise ValueError("network_def needs at least an embedding and a head")
    first, last = network_def[0], network_def[-1]
    if block_type(first) not in EMBED_TYPES:
        raise ValueError(f"first block must be an embedding, got type {block_type(first)}")
    if block_type(last) != HEAD:
        raise ValueError(f"last block must be the classifier head, got type {block_type(last)}")

    embed_dim = embed_channels(first)
    for i, block in enumerate(network_def[1:-1], start=1):
        btype = block_type(block)
        if btype == TRANSFORMER:
            tdef = transformer_def(block)
            if tdef.embed_dim != embed_dim:
                raise ValueError(
                    f"block {i}: embed dim {tdef.embed_dim} inconsistent with stage width {embed_dim}"
                )
        elif btype == SPATIAL_REDUCTION:
            in_ch, out_ch = sr_channels(block)
            if in_ch != embed_dim:
                raise ValueError(f"block {i}: SR in_channels {in_ch} != stage width {embed_dim}")
            if out_ch < in_ch:
                raise ValueError(f"block {i}: SR out_channels {out_ch} < in_channels {in_ch}")
            embed_dim = out_ch
        else:
            raise ValueError(f"block {i}: unexpected block type {btype}")

    head_in, _ = head_channels(last)
    if head_in != embed_dim:
        raise ValueError(f"head in_channels {head_in} != final stage width {embed_dim}")


# --- Structure queries ---------------------------------------------------------


def transformer_depth(network_def: Sequence) -> int:
    """Number of transformer-block slots (existing or not)."""
    return sum(1 for b in network_def if block_type(b) == TRANSFORMER)


def existing_depth(network_def: Sequence) -> int:
    return sum(1 for b in network_def if block_type(b) == TRANSFORMER and b[3])


def stage_widths(network_def: Sequence) -> List[int]:
    """Embedding width of each stage, in order."""
    widths = [embed_channels(network_def[0])]
    for block in network_def:
        if block_type(block) == SPATIAL_REDUCTION:
            widths.append(sr_channels(block)[1])
    return widths


def num_stages(network_def: Sequence) -> int:
    return 1 + sum(1 for b in network_def if block_type(b) == SPATIAL_REDUCTION)


# --- IR transforms --------------------------------------------------------------


def update_embed_size(network_def: List) -> List:
    """Propagate per-stage embedding widths through the network in place.

    After changing the patch-embedding width or an SR block's output width,
    every transformer block, SR input and the head within the affected stage
    must agree on the stage width.  Reference: search_utils/gen_utils.py:64-80.
    """
    embed_size = network_def[0][1]
    for i in range(1, len(network_def)):
        btype = block_type(network_def[i])
        if btype == TRANSFORMER:
            network_def[i][1][0] = embed_size
            network_def[i][2][0] = embed_size
        elif btype == HEAD:
            network_def[i][1] = embed_size
        elif btype == SPATIAL_REDUCTION:
            network_def[i][1] = embed_size
            embed_size = network_def[i][2]
        else:
            raise ValueError(f"unexpected block type {btype} at index {i}")
    return network_def


def update_depth(network_def: List, num_channels_to_keep: Sequence) -> List:
    """Cascade block removals over consecutive removable blocks, in place.

    A transformer block whose search space allows removal
    (``num_channels_to_keep[i]['layer'] is not None``) is forced to removed
    state when the most recent *removable* block (with no non-removable block
    in between) was removed.  Non-removable blocks reset the cascade.
    Reference semantics: search_utils/gen_utils.py:83-108.
    """
    remove_block = False
    for i, block in enumerate(network_def):
        if block_type(block) != TRANSFORMER:
            continue
        keep = num_channels_to_keep[i]
        if keep is None or keep.get("layer") is None:
            remove_block = False
        else:
            if remove_block:
                network_def[i][3] = 0
            elif not block[3]:
                remove_block = True
    return network_def
