"""Multi-stage vision transformer with spatial reduction, built from a
``network_def``.

Port of vit_search_tpu/models/vit_sr.py. The same module serves dense nets
(``masks=None``) and any sampled sub-architecture (masks from
``models.supernet.build_arch_masks``, whose ``"counts"`` the blocks take on
CUDA tensors). Removed blocks (exists=0) are parameterless bypass slots that
reset the layer-mask chain.

Parameter names follow the reference torch state dict: ``blocks.<j>`` counts
every slot between the stem and the head, bypass slots included.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..arch import network_def as nd
from ..device import resolve_device
from ..ops.dropout import dropout
from .layers import Block, MaskedLayerNorm, apply_mask, linear, make_linear, trunc_normal_
from .patch_embed import PatchConvEmbed, PatchEmbed, conv2d, make_conv


class Bypass(nn.Module):
    """A removed transformer slot: no parameters, drops the layer-mask chain."""


class SpatialReductionPatchEmbed(nn.Module):
    """Between-stage token-grid reduction (2x) with width expansion.

    Patch path: masked-LN -> 3x3 stride-2 conv on the token grid -> new
    position embedding; residual 2x2 average pool, zero-padded to
    ``out_features``. Token path: masked-LN -> linear; residual zero-padded.
    """

    def __init__(self, grid: int, in_features: int, out_features: int, num_tokens: int,
                 dtype: torch.dtype, generator: torch.Generator, reduction: int = 2,
                 ln_route: str = "fused"):
        super().__init__()
        if out_features < in_features:
            raise ValueError("SR block cannot narrow the embedding")
        self.grid, self.num_tokens, self.reduction, self.dtype = grid, num_tokens, reduction, dtype
        self.in_features, self.out_features = in_features, out_features
        out_grid = grid // reduction
        self.norm = MaskedLayerNorm(in_features, route=ln_route)
        self.patch_reduce = make_conv(in_features, out_features, reduction + 1, reduction,
                                      reduction // 2, True, generator, "trunc_normal")
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, out_grid * out_grid, out_features), generator))
        self.token_transform = make_linear(in_features, out_features, generator)

    def forward(self, x: torch.Tensor, embed_mask: Optional[torch.Tensor] = None,
                out_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b = x.shape[0]
        t, g, r = self.num_tokens, self.grid, self.reduction
        pad = self.out_features - self.in_features

        normed = self.norm(x, embed_mask)
        grid_nchw = normed[:, t:].reshape(b, g, g, self.in_features).permute(0, 3, 1, 2)
        patches = conv2d(grid_nchw, self.patch_reduce, self.dtype).flatten(2).transpose(1, 2)
        patches = patches + self.pos_embed.to(patches.dtype)

        pres = x[:, t:].reshape(b, g, g, self.in_features).permute(0, 3, 1, 2)
        pres = F.avg_pool2d(pres, r, r).flatten(2).transpose(1, 2)
        tokens = linear(normed[:, :t], self.token_transform, self.dtype)

        out = torch.cat([tokens, patches], dim=1)
        residual = F.pad(torch.cat([x[:, :t], pres], dim=1), (0, pad))
        return apply_mask(out + residual.to(out.dtype), out_mask), out_mask


class VisionTransformerSR(nn.Module):
    """Flexible (multi-stage) ViT parameterized by a ``network_def``.

    ``model(x, masks=None, patch_output_type=None)`` with NHWC images
    returns ``cls_logits``, ``(cls_logits, dst_logits)`` (distill token) or,
    when training with ``patch_output``, ``(cls_logits, patch_logits)``
    with per-token patch logits (``'seq'``). ``dropout_rate`` drops after the
    position embedding and in every block's MLP and projection,
    ``attn_dropout_rate`` on the attention probabilities (the plain
    attention route); every published recipe trains with both at 0.

    Parameters are float32; ``dtype`` is the compute type. The module is
    built from ``seed`` on the CPU and moved to ``device`` (the CUDA device
    unless ``"cpu"`` is asked for). ``ln_route`` is the route of every masked
    layer norm: ``"fused"`` (kernels K3/K4) or ``"stats"`` (K5's row sums,
    the rest plain PyTorch); see ``ops.masked_layer_norm``.
    """

    def __init__(self, network_def, img_size: int = 224, patch_size: int = 14,
                 num_classes: int = 1000, distill_token: bool = False,
                 patch_output: bool = False, drop_path_rate: float = 0.0,
                 gelu: str = "exact", dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0, ln_route: str = "fused",
                 dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0):
        super().__init__()
        device = resolve_device(device)
        if patch_output and distill_token:
            raise ValueError("patch_output and distillation are mutually exclusive")
        net = nd.to_immutable(network_def)
        nd.validate(net)
        head_in, head_classes = nd.head_channels(net[-1])
        if head_classes != num_classes:
            raise ValueError(f"head has {head_classes} classes, model {num_classes}")
        self.network_def = net
        self.distill_token = distill_token
        self.num_tokens = 2 if distill_token else 1
        self.patch_output = patch_output
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.img_size, self.patch_size = img_size, patch_size
        gen = torch.Generator().manual_seed(seed)

        stem = net[0]
        embed_dim = nd.embed_channels(stem)
        if nd.block_type(stem) == nd.LINEAR_EMBED:
            self.patch_embed = PatchEmbed(img_size, patch_size, embed_dim, dtype, gen)
        else:
            mid = nd.conv_mid_channels(stem) if nd.block_type(stem) == nd.FLEX_CONV_EMBED else 24
            self.patch_embed = PatchConvEmbed(img_size, patch_size, embed_dim, mid, dtype, gen)

        grid = img_size // patch_size
        self.tokens = nn.Parameter(trunc_normal_(
            torch.empty(1, self.num_tokens, embed_dim), gen))
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, grid * grid + self.num_tokens, embed_dim), gen))

        depth = nd.existing_depth(net)
        dpr = np.linspace(0.0, drop_path_rate, depth) if depth else []
        blocks, d = [], 0
        for block_def in net[1:-1]:
            if nd.block_type(block_def) == nd.TRANSFORMER:
                tdef = nd.transformer_def(block_def)
                if tdef.exists:
                    blocks.append(Block(embed_dim, tdef.num_heads, tdef.head_dim,
                                        tdef.ffn_hidden, float(dpr[d]), gelu, dtype, gen,
                                        ln_route, dropout_rate, attn_dropout_rate))
                    d += 1
                else:
                    blocks.append(Bypass())
            else:
                _, out_ch = nd.sr_channels(block_def)
                blocks.append(SpatialReductionPatchEmbed(grid, embed_dim, out_ch,
                                                         self.num_tokens, dtype, gen,
                                                         ln_route=ln_route))
                grid //= 2
                embed_dim = out_ch
        self.blocks = nn.ModuleList(blocks)
        if head_in != embed_dim:
            raise ValueError(f"head width {head_in} != final stage width {embed_dim}")

        self.norm = MaskedLayerNorm(embed_dim, route=ln_route)
        self.cls_head = make_linear(embed_dim, num_classes, gen)
        if distill_token:
            self.dst_head = make_linear(embed_dim, num_classes, gen)
        if patch_output:
            self.patch_head = make_linear(embed_dim, num_classes, gen)
        self.to(device)

    def forward_features(self, x: torch.Tensor, masks: Optional[Dict], want_patches: bool,
                         drop_keeps: Optional[Iterable[torch.Tensor]],
                         generator: Optional[torch.Generator],
                         dropout_keeps: Optional[Iterable[torch.Tensor]] = None):
        t = self.num_tokens
        x = self.patch_embed(x)
        tokens = self.tokens.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([tokens, x], dim=1) + self.pos_embed.to(x.dtype)
        dropout_keeps = None if dropout_keeps is None else iter(dropout_keeps)
        x = dropout(x, self.dropout_rate, self.training, dropout_keeps, generator)

        embed_mask = layer_mask = None
        if masks is not None and masks.get("embed") is not None:
            embed_mask = masks["embed"]
            x = apply_mask(x, embed_mask)

        keeps = None if drop_keeps is None else iter(drop_keeps)
        slot_masks = (masks or {}).get("slots", {})
        counts = (masks or {}).get("counts") or {}
        embed_count, slot_counts = counts.get("embed"), counts.get("slots", {})
        for slot, block in enumerate(self.blocks, start=1):
            if isinstance(block, Bypass):
                layer_mask = None
            elif isinstance(block, Block):
                x, layer_mask = block(x, embed_mask, layer_mask, slot_masks.get(slot),
                                      keeps, generator, dropout_keeps, slot_counts.get(slot),
                                      embed_count)
            else:
                sr_mask = (slot_masks.get(slot) or {}).get("embed")
                x, embed_mask = block(x, embed_mask, sr_mask)
                embed_count = (slot_counts.get(slot) or {}).get("embed")
                layer_mask = None

        if want_patches:
            x = self.norm(x, embed_mask)
            return x[:, :t], x[:, t:]
        return self.norm(x[:, :t], embed_mask), None

    def forward(self, x: torch.Tensor, masks: Optional[Dict] = None,
                patch_output_type: Optional[str] = None,
                drop_keeps: Optional[Iterable[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_keeps: Optional[Iterable[torch.Tensor]] = None):
        """``drop_keeps``: stochastic-depth keep draws in call order (each
        block's attention branch, then its MLP branch); ``dropout_keeps``:
        dropout keep masks in call order (shapes: :meth:`dropout_shapes`);
        ``None`` draws either from ``generator``."""
        want_patches = self.patch_output and self.training
        token_features, patch_features = self.forward_features(
            x, masks, want_patches, drop_keeps, generator, dropout_keeps)
        cls_pred = linear(token_features[:, 0], self.cls_head, self.dtype)
        if self.patch_output:
            if not want_patches:
                return cls_pred
            if patch_output_type not in ("seq", None):
                raise NotImplementedError(f"patch_output_type {patch_output_type!r}")
            return cls_pred, linear(patch_features, self.patch_head, self.dtype)
        if self.num_tokens == 2:
            return cls_pred, linear(token_features[:, 1], self.dst_head, self.dtype)
        return cls_pred

    def dropout_shapes(self, batch: int) -> List[tuple]:
        """The shapes of the dropout keep masks one training forward draws,
        in call order: after the position embedding, then each block's (see
        :meth:`Block.dropout_shapes`). Empty when both rates are 0."""
        grid = self.img_size // self.patch_size
        width = self.pos_embed.shape[-1]
        shapes = []
        if self.dropout_rate > 0.0:
            shapes.append((batch, grid * grid + self.num_tokens, width))
        for block in self.blocks:
            if isinstance(block, Block):
                shapes += block.dropout_shapes(batch, grid * grid + self.num_tokens)
            elif isinstance(block, SpatialReductionPatchEmbed):
                grid //= block.reduction
        return shapes
