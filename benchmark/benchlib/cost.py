"""Frozen copy of the port's MAC/FLOP arithmetic (``arch/cost.py``, itself
the published ``network_utils/compute_flop_mac.py``), kept with the
benchmark so that the yardstick stays as it is while the program changes.
The network_def accessors it needs are written out below;
``benchmark/tests/test_bench_cost.py`` holds it to the port's estimator.
"""

from __future__ import annotations

from typing import Optional, Sequence

LINEAR_EMBED, TRANSFORMER, HEAD, SPATIAL_REDUCTION, CONV_EMBED, FLEX_CONV_EMBED = range(6)
EMBED_TYPES = (LINEAR_EMBED, CONV_EMBED, FLEX_CONV_EMBED)


class _Transformer:
    def __init__(self, block: Sequence):
        (self.embed_dim, self.num_heads, self.head_dim), (_, self.ffn_hidden) = block[1], block[2]
        self.exists = bool(block[3])


class nd:
    """The accessors of the network_def wire format that the cost model reads."""

    LINEAR_EMBED, TRANSFORMER, SPATIAL_REDUCTION = LINEAR_EMBED, TRANSFORMER, SPATIAL_REDUCTION
    CONV_EMBED, FLEX_CONV_EMBED, EMBED_TYPES = CONV_EMBED, FLEX_CONV_EMBED, EMBED_TYPES

    @staticmethod
    def block_type(block):
        return int(block[0])

    @staticmethod
    def transformer_def(block):
        return _Transformer(block)

    @staticmethod
    def embed_channels(block):
        return int(block[1])

    @staticmethod
    def conv_mid_channels(block):
        return int(block[2])

    @staticmethod
    def sr_channels(block):
        return int(block[1]), int(block[2])

    @staticmethod
    def head_channels(block):
        return int(block[1]), int(block[2])


_SOFTMAX_FLOPS = 5
_LAYER_NORM_FLOPS = 5
_GELU_FLOPS = 8

_NUM_INPUT_CHANNELS = 3
_DEFAULT_NUM_CLASSES = 1000

_DEFAULT_PATCH_SIZE = 16

class _Factors:
    """Per-convention multipliers: MACs count only the multiply-adds."""

    def __init__(self, return_mac: bool):
        self.mul = 1 if return_mac else 2   # multiply-add factor
        self.bias = 0 if return_mac else 1
        self.misc = 0 if return_mac else 1


def attention_cost(embed_dim: int, num_heads: int, head_dim: int, n_seq: int,
                   return_mac: bool = True) -> int:
    """QKV projection + scores + weighted average + output projection.

    Reference: network_utils/compute_flop_mac.py:53-74.
    """
    f = _Factors(return_mac)
    width = num_heads * head_dim
    c = 0
    c += embed_dim * width * 3 * n_seq * f.mul          # x -> qkv
    c += width * 3 * n_seq * f.bias
    c += n_seq * n_seq * width * f.mul                  # q @ k^T
    c += n_seq * num_heads * n_seq * _SOFTMAX_FLOPS * f.misc
    c += n_seq * n_seq * num_heads * f.misc             # scale
    c += n_seq * n_seq * width * f.mul                  # attn @ v
    c += n_seq * width * embed_dim * f.mul              # output projection
    c += n_seq * embed_dim * f.bias
    c += n_seq * embed_dim * f.misc                     # residual add
    c += n_seq * embed_dim * _LAYER_NORM_FLOPS * f.misc
    return c


def ffn_cost(embed_dim: int, hidden: int, n_seq: int, return_mac: bool = True) -> int:
    """Two-layer MLP. Reference: network_utils/compute_flop_mac.py:77-93."""
    f = _Factors(return_mac)
    c = 0
    c += n_seq * embed_dim * hidden * f.mul
    c += n_seq * hidden * f.bias
    c += n_seq * hidden * _GELU_FLOPS * f.misc
    c += n_seq * embed_dim * hidden * f.mul
    c += n_seq * embed_dim * f.bias
    c += n_seq * embed_dim * f.misc                     # residual add
    c += n_seq * embed_dim * _LAYER_NORM_FLOPS * f.misc
    return c


def transformer_block_cost(block: Sequence, n_seq: int, return_mac: bool = True) -> int:
    """Reference: network_utils/compute_flop_mac.py:96-120."""
    tdef = nd.transformer_def(block)
    if not tdef.exists:
        return 0
    return (attention_cost(tdef.embed_dim, tdef.num_heads, tdef.head_dim, n_seq, return_mac)
            + ffn_cost(tdef.embed_dim, tdef.ffn_hidden, n_seq, return_mac))


def patch_embedding_cost(embed_dim: int, num_patches: int, num_chs: int = _NUM_INPUT_CHANNELS,
                         patch_size: int = _DEFAULT_PATCH_SIZE, return_mac: bool = True,
                         mid_chs: Optional[int] = None, conv_embedding: bool = False) -> int:
    """Linear or convolutional patch stem.

    The conv stem is stride-2 3x3 conv + two more 3x3 convs at 112px, then a
    (patch/2)-strided projection.  Reference: network_utils/compute_flop_mac.py:123-147
    (which hard-codes the 112px mid resolution, i.e. assumes a 224px input).
    """
    f = _Factors(return_mac)
    c = 0
    if conv_embedding:
        if mid_chs is None:
            raise ValueError("the conv stem needs mid_chs")
        k = 3
        mid_res = 112
        proj_patch = patch_size // 2
        c += (num_chs * mid_chs * k * k) * mid_res * mid_res * f.mul
        c += (mid_chs * mid_res * mid_res) * f.bias
        c += (mid_chs * mid_chs * k * k) * mid_res * mid_res * f.mul * 2
        c += (mid_chs * mid_res * mid_res) * f.bias * 2
        c += (embed_dim * mid_chs) * proj_patch * proj_patch * num_patches * f.mul
        c += embed_dim * num_patches * f.bias
    else:
        c += (embed_dim * num_chs) * patch_size * patch_size * num_patches * f.mul
        c += embed_dim * num_patches * f.bias
    return c


def position_embedding_cost(embed_dim: int, n_seq: int, return_mac: bool = True) -> int:
    return embed_dim * n_seq * _Factors(return_mac).bias


def head_cost(embed_dim: int, n_seq: int, num_classes: int = _DEFAULT_NUM_CLASSES,
              return_mac: bool = True) -> int:
    """Final norm + classifier. Reference: network_utils/compute_flop_mac.py:155-166."""
    f = _Factors(return_mac)
    c = embed_dim * _LAYER_NORM_FLOPS * f.misc
    c += embed_dim * num_classes * f.mul
    c += n_seq * num_classes * f.bias
    return c


def sr_block_cost(img_size: int, patch_size: int, num_in: int, num_out: int,
                  distill: bool, return_mac: bool = True) -> int:
    """Spatial-reduction patch embedding between stages.

    (patch+1)-kernel strided conv over the token grid, new position embedding,
    and a linear transform of the class (and distill) token.
    Reference: network_utils/compute_flop_mac.py:169-194.
    """
    f = _Factors(return_mac)
    if img_size % patch_size:
        raise ValueError(f"grid {img_size} is not a multiple of the SR patch {patch_size}")
    out_size = img_size // patch_size
    c = 0
    c += (out_size * out_size * num_out) * ((patch_size + 1) * (patch_size + 1) * num_in) * f.mul
    c += out_size * out_size * num_out * f.bias
    c += out_size * out_size * num_out * _LAYER_NORM_FLOPS * f.misc
    c += out_size * out_size * num_out * f.bias            # position embedding

    token = 0
    token += num_in * _LAYER_NORM_FLOPS * f.misc
    token += num_in * num_out * f.mul
    token += num_out * f.bias
    token += num_in * f.misc                               # residual add
    if distill:
        token *= 2
    return c + token


class ComputationEstimator:
    """MAC/FLOP estimator for (multi-stage) ViTs described by ``network_def``.

    Walks the network tracking sequence length, token-grid size and stage
    width across SR blocks.  Reference: network_utils/compute_flop_mac.py:227-307
    (minus its stray debug ``print``).
    """

    SR_PATCH_SIZE = 2  # SR blocks always halve the token grid

    def __init__(self, distill: bool, input_resolution: int, patch_size: int,
                 num_in_channels: int = _NUM_INPUT_CHANNELS, return_mac: bool = True):
        if input_resolution % patch_size:
            raise ValueError(f"resolution {input_resolution} is not a multiple of patch "
                             f"{patch_size}")
        self.distill = distill
        self.input_resolution = input_resolution
        self.patch_size = patch_size
        self.num_in_channels = num_in_channels
        self.return_mac = return_mac

    def __repr__(self) -> str:
        return ("ComputationEstimator(distill={}, input_resolution={}, patch_size={}, "
                "sr_patch_size={}, num_in_channels={}, return_mac={})").format(
                    self.distill, self.input_resolution, self.patch_size,
                    self.SR_PATCH_SIZE, self.num_in_channels, self.return_mac)

    @property
    def _num_tokens(self) -> int:
        return 2 if self.distill else 1

    def __call__(self, network_def: Sequence) -> int:
        return_mac = self.return_mac
        img_size = self.input_resolution // self.patch_size
        num_patches = img_size * img_size
        n_seq = num_patches + self._num_tokens

        stem = network_def[0]
        stem_type = nd.block_type(stem)
        if stem_type not in nd.EMBED_TYPES:
            raise ValueError("network_def error: embedding")
        embed_dim = nd.embed_channels(stem)
        conv_embedding = stem_type != nd.LINEAR_EMBED
        mid_chs = None
        if stem_type == nd.FLEX_CONV_EMBED:
            mid_chs = nd.conv_mid_channels(stem)
        elif stem_type == nd.CONV_EMBED:
            mid_chs = 24  # fixed stem width of the non-flexible conv embedding

        c = patch_embedding_cost(embed_dim, num_patches, num_chs=self.num_in_channels,
                                 patch_size=self.patch_size, return_mac=return_mac,
                                 conv_embedding=conv_embedding, mid_chs=mid_chs)
        c += position_embedding_cost(embed_dim, n_seq=n_seq, return_mac=return_mac)

        for i, block in enumerate(network_def):
            btype = nd.block_type(block)
            if btype == nd.TRANSFORMER:
                tdef = nd.transformer_def(block)
                if tdef.embed_dim != embed_dim:
                    raise ValueError(f"block {i}: embed dim inconsistent")
                c += transformer_block_cost(block, n_seq=n_seq, return_mac=return_mac)
            elif btype == nd.SPATIAL_REDUCTION:
                in_ch, out_ch = nd.sr_channels(block)
                if in_ch != embed_dim:
                    raise ValueError(f"block {i}: SR input {in_ch} != stage width {embed_dim}")
                c += sr_block_cost(img_size, patch_size=self.SR_PATCH_SIZE,
                                   num_in=in_ch, num_out=out_ch,
                                   distill=self.distill, return_mac=return_mac)
                img_size //= self.SR_PATCH_SIZE
                num_patches = img_size * img_size
                n_seq = num_patches + self._num_tokens
                embed_dim = out_ch

        _, num_classes = nd.head_channels(network_def[-1])
        head = head_cost(embed_dim, n_seq=n_seq, num_classes=num_classes, return_mac=return_mac)
        if self.distill:
            head *= 2
        return c + head


def macs(network_def: Sequence, input_resolution: int, patch_size: int = 14,
         distill: bool = False) -> int:
    """Multiply-accumulates of one image through ``network_def``."""
    return ComputationEstimator(distill, input_resolution, patch_size)(network_def)
