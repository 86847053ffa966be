"""Masked transformer building blocks.

Port of vit_search_tpu/models/layers.py. Channel masks arrive as call
arguments (``(B, 1, width)`` boolean tensors built from per-step keep counts):

- the attention mask zeroes trailing heads' outputs before the projection,
- the MLP mask zeroes trailing hidden units between fc1 and fc2,
- the layer mask (all-or-nothing per example) is ANDed with the previous
  block's layer mask and the stage embed mask, and multiplies both residual
  branches.

Every mask keeps a prefix of channels, so on a CUDA tensor a block takes the
masks' per-example keep counts instead (``(B,)`` int32, the ``"counts"`` of
``models.supernet.build_arch_masks``) and applies them, with drop path's
scale, inside the passes that touch the data (``ops/prefix_mask.py``): the
hidden mask inside GELU, the branch masks and drop path inside the residual
add, the head mask on its own. The AND of prefix masks is the prefix of the
smaller count. A CPU tensor, or a mask tree without counts, runs the boolean
multiplies op for op.

Parameters are float32 and named after the reference torch state dict; each
layer casts its weights to the compute ``dtype`` at the call, as flax's
``dtype=`` does. Dropout sits where the JAX blocks put it: after the MLP's
GELU and after fc2 (``dropout_rate``), on the attention probabilities
(``attn_dropout_rate``, which sends attention to the plain route, as the JAX
``supported`` does) and after the projection (``dropout_rate``). Its keep
masks come from ``dropout_keeps`` (an iterator, in call order) when given,
else from ``generator``.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import prefix_mask
from ..ops.attention import attention_qkv_plain, fused_attention_qkv, supported
from ..ops.drop_path import drop_path
from ..ops.dropout import dropout
from ..ops.masked_layer_norm import masked_layer_norm
from ..ops.prefix_mask import branch_add, drop_path_scale, prefix_gelu, prefix_scale

INIT_STD = 0.02
GELU_FORMS = ("exact", "tanh")


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = INIT_STD) -> torch.Tensor:
    """Normal(0, std) truncated at two standard deviations."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal with variance 1/fan_in."""
    fan_in = t[0].numel()
    # std of a unit normal truncated at +-2 is 0.8796; rescale to unit variance
    return trunc_normal_(t, generator, std=math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def make_linear(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        trunc_normal_(layer.weight, generator)
        layer.bias.zero_()
    return layer


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero masked channels; no-op for ``None``."""
    return x if mask is None else x * mask.to(x.dtype)


def combine_masks(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND of two optional boolean masks."""
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a.bool(), b.bool())


def attention_with_dropout(qkv: torch.Tensor, scale: float, num_heads: int, rate: float,
                           training: bool, keeps: Optional[Iterator[torch.Tensor]] = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The JAX model's XLA attention (vit_search_tpu/models/layers.py:147-159),
    which it takes under attention dropout: scores and softmax in float32,
    the ``(B, H, N, N)`` probabilities cast to the compute dtype and dropped
    out, then ``p @ v`` in the compute dtype."""
    b, n, w3 = qkv.shape
    q, k, v = qkv.view(b, n, 3, num_heads, w3 // (3 * num_heads)).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = dropout(torch.softmax(s, dim=-1).to(qkv.dtype), rate, training, keeps, generator)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n, w3 // 3)


class MaskedLayerNorm(nn.Module):
    """Layer norm with masked-channel-corrected statistics (always affine);
    ``route`` is the masked path's route, ``"fused"`` or ``"stats"``."""

    def __init__(self, features: int, eps: float = 1e-6, route: str = "fused"):
        super().__init__()
        self.eps, self.route = eps, route
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return masked_layer_norm(x, self.weight, self.bias, mask, self.eps, self.route)


class Mlp(nn.Module):
    """fc1 -> GELU -> dropout -> [hidden mask] -> fc2 -> dropout. ``gelu``
    is ``"exact"`` (erf) or ``"tanh"`` (the approximation). The hidden mask is
    ``hidden_mask`` (boolean) or ``hidden_count`` (per-example keep counts),
    which goes inside the GELU's pass where no dropout acts."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 gelu: str, dtype: torch.dtype, generator: torch.Generator,
                 dropout_rate: float = 0.0):
        super().__init__()
        if gelu not in GELU_FORMS:
            raise ValueError(f"gelu must be one of {GELU_FORMS}, got {gelu!r}")
        self.gelu, self.dtype, self.dropout_rate = gelu, dtype, dropout_rate
        self.fc1 = make_linear(in_features, hidden_features, generator)
        self.fc2 = make_linear(hidden_features, out_features, generator)

    def forward(self, x: torch.Tensor, hidden_mask: Optional[torch.Tensor] = None,
                dropout_keeps: Optional[Iterator[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                hidden_count: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = linear(x, self.fc1, self.dtype)
        if hidden_count is not None and not (self.training and self.dropout_rate > 0.0):
            x = prefix_gelu(x, hidden_count, self.gelu)
        else:
            x = F.gelu(x, approximate="tanh" if self.gelu == "tanh" else "none")
            x = dropout(x, self.dropout_rate, self.training, dropout_keeps, generator)
            x = (apply_mask(x, hidden_mask) if hidden_count is None
                 else prefix_scale(x, hidden_count))
        x = linear(x, self.fc2, self.dtype)
        return dropout(x, self.dropout_rate, self.training, dropout_keeps, generator)


class Attention(nn.Module):
    """Multi-head self-attention with explicit head_dim and head masking.

    ``qkv`` maps ``dim -> 3 * num_heads * head_dim`` with column blocks
    ``[q | k | v]``, each ordered by head, so prefix slicing per third
    extracts a subnet. The head mask (``width_mask``, boolean, or
    ``width_count``, per-example keep counts) applies after attention.
    """

    def __init__(self, dim: int, num_heads: int, head_dim: int, out_features: int,
                 dtype: torch.dtype, generator: torch.Generator,
                 attn_dropout_rate: float = 0.0, proj_dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads, self.head_dim, self.dtype = num_heads, head_dim, dtype
        self.attn_dropout_rate, self.proj_dropout_rate = attn_dropout_rate, proj_dropout_rate
        width = num_heads * head_dim
        self.qkv = make_linear(dim, 3 * width, generator)
        self.proj = make_linear(width, out_features, generator)

    def forward(self, x: torch.Tensor, width_mask: Optional[torch.Tensor] = None,
                dropout_keeps: Optional[Iterator[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                width_count: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale = self.head_dim ** -0.5
        qkv = linear(x, self.qkv, self.dtype)
        if supported(x.shape[1], self.head_dim, self.attn_dropout_rate):
            out = fused_attention_qkv(qkv, scale, self.num_heads)
        elif self.attn_dropout_rate > 0.0:
            out = attention_with_dropout(qkv, scale, self.num_heads, self.attn_dropout_rate,
                                         self.training, dropout_keeps, generator)
        else:
            out = attention_qkv_plain(qkv, scale, self.num_heads)
        out = apply_mask(out, width_mask) if width_count is None else prefix_scale(out, width_count)
        out = linear(out, self.proj, self.dtype)
        return dropout(out, self.proj_dropout_rate, self.training, dropout_keeps, generator)

    def dropout_shapes(self, batch: int, n: int) -> Tuple[tuple, ...]:
        """The shapes of the keep masks one training call draws, in order."""
        shapes = ()
        if self.attn_dropout_rate > 0.0:
            shapes += ((batch, self.num_heads, n, n),)
        if self.proj_dropout_rate > 0.0:
            shapes += ((batch, n, self.proj.out_features),)
        return shapes


class Block(nn.Module):
    """Pre-norm transformer block with attention/MLP/layer masking.

    ``(x, embed_mask, layer_mask, masks) -> (x, new_layer_mask)``; ``masks``
    holds optional ``attn``/``mlp``/``layer`` entries. Stochastic depth takes
    its keep draws from ``keeps`` (an iterator, attention branch first) when
    given, else from ``generator``; dropout likewise from ``dropout_keeps``.
    ``ln_route`` is both norms' route.

    An ``x`` on the kernels' route (``ops.prefix_mask.kernel_route``: a
    CUDA tensor) whose block has no boolean site masks (and whose
    ``embed_mask``, if any, comes with ``embed_count``) takes the count route:
    ``counts`` holds the site's ``attn``/``mlp``/``layer`` keep counts, and the
    layer-and-embed chain, ``layer_mask`` in and out, is a count vector.
    """

    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_hidden: int,
                 drop_path_rate: float, gelu: str, dtype: torch.dtype,
                 generator: torch.Generator, ln_route: str = "fused",
                 dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = MaskedLayerNorm(dim, route=ln_route)
        self.attn = Attention(dim, num_heads, head_dim, dim, dtype, generator,
                              attn_dropout_rate, dropout_rate)
        self.norm2 = MaskedLayerNorm(dim, route=ln_route)
        self.mlp = Mlp(dim, mlp_hidden, dim, gelu, dtype, generator, dropout_rate)

    def _drop_path(self, x: torch.Tensor, keeps: Optional[Iterator[torch.Tensor]],
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.drop_path_rate == 0.0:
            return x
        keep = next(keeps) if keeps is not None else None
        return drop_path(x, self.drop_path_rate, True, keep=keep, generator=generator)

    def _add(self, x: torch.Tensor, f: torch.Tensor, count: Optional[torch.Tensor],
             keeps: Optional[Iterator[torch.Tensor]],
             generator: Optional[torch.Generator]) -> torch.Tensor:
        """``x + f`` with the branch's count mask and drop path in one pass."""
        scale = None
        if self.training and self.drop_path_rate > 0.0:
            keep = next(keeps) if keeps is not None else None
            scale = drop_path_scale(x.shape[0], self.drop_path_rate, x.device, keep, generator)
        if count is None and scale is None:
            return x + f
        return branch_add(x, f, count, scale)

    def forward(self, x: torch.Tensor, embed_mask: Optional[torch.Tensor] = None,
                layer_mask: Optional[torch.Tensor] = None, masks: Optional[dict] = None,
                keeps: Optional[Iterator[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_keeps: Optional[Iterator[torch.Tensor]] = None,
                counts: Optional[dict] = None, embed_count: Optional[torch.Tensor] = None):
        if (prefix_mask.kernel_route(x) and not masks
                and (embed_mask is None or embed_count is not None)):
            return self._forward_counts(x, embed_mask, layer_mask, counts or {}, embed_count,
                                        keeps, generator, dropout_keeps)
        masks = masks or {}
        own_layer_mask = masks.get("layer")

        f = self.attn(self.norm1(x, embed_mask), masks.get("attn"), dropout_keeps, generator)
        f = self._drop_path(f, keeps, generator)

        # layer-mask chaining: only blocks with their own layer site consider
        # the incoming mask
        if own_layer_mask is not None:
            f = apply_mask(f, own_layer_mask)
            current = combine_masks(own_layer_mask, layer_mask)
        else:
            current = None
        if embed_mask is not None:
            current = embed_mask if current is None else combine_masks(current, embed_mask)
            f = apply_mask(f, current)
        x = x + f

        f = self.mlp(self.norm2(x, embed_mask), masks.get("mlp"), dropout_keeps, generator)
        f = self._drop_path(f, keeps, generator)
        if current is not None:
            f = apply_mask(f, current)
        return x + f, current

    def _forward_counts(self, x, embed_mask, layer_count, counts, embed_count, keeps, generator,
                        dropout_keeps):
        """The forward on keep counts: the chain is the minimum of the own
        layer count, the incoming chain and the embed count, or the embed
        count alone where the block has no layer site."""
        current = counts.get("layer")
        if current is not None and layer_count is not None:
            current = torch.minimum(current, layer_count)
        if embed_count is not None:
            current = embed_count if current is None else torch.minimum(current, embed_count)

        f = self.attn(self.norm1(x, embed_mask), None, dropout_keeps, generator,
                      counts.get("attn"))
        x = self._add(x, f, current, keeps, generator)
        f = self.mlp(self.norm2(x, embed_mask), None, dropout_keeps, generator,
                     counts.get("mlp"))
        return self._add(x, f, current, keeps, generator), current

    def dropout_shapes(self, batch: int, n: int) -> Tuple[tuple, ...]:
        """The shapes of the keep masks one training call draws, in order:
        the attention's, then the MLP's (after GELU, after fc2)."""
        mlp = self.mlp
        shapes = self.attn.dropout_shapes(batch, n)
        if mlp.dropout_rate > 0.0:
            shapes += ((batch, n, mlp.fc1.out_features), (batch, n, mlp.fc2.out_features))
        return shapes
