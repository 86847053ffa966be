"""EVA-02: a plain ViT with 2D rotary position embeddings, sub-LN attention
and a SwiGLU MLP with its own layer norm.

Port of ``eva02_large_patch14_xattn_fusedLN_NaiveSwiGLU_subln_RoPE`` in
``EVA-02/asuka/modeling_finetune.py`` of github.com/baaivision/EVA (Fang et
al., "EVA-02: A Visual Representation for Neon Genesis", arXiv:2303.11331),
not of the JAX package, which has no EVA. Parameter names follow that file's
state dict (``blocks.{i}.attn.q_proj.weight``, ``.attn.q_bias``,
``.attn.inner_attn_ln.weight``, ``.mlp.w1.weight``, ``.mlp.ffn_ln.weight``,
...). Its parts:

- a 14 x 14 stride-14 patch projection, a cls token and a learned absolute
  position embedding over the cls and patch tokens;
- pre-norm blocks, ``x + drop_path(proj(inner_attn_ln(attn(norm1(x)))))``
  then ``x + drop_path(w3(ffn_ln(silu(w1 x) * w2 x)))`` on ``norm2(x)``, no
  LayerScale; q and v have biases, k has none;
- the attention of ``ops.rope_attention`` with EVA-02's
  ``VisionRotaryEmbeddingFast`` tables on the patch tokens (the cls token,
  row 0, unrotated), built once per resolution as buffers;
- the mean of the patch tokens, ``fc_norm`` and the head.

Every layer norm but the MLP's is ``masked_layer_norm(mask=None)`` at eps
1e-6 (on the card, K3/K4's dense mode); the MLP's sits inside
``ops.swiglu_ln`` (G1/G2). The q, k and v projections run as one GEMM over
their weights stacked, and so do ``w1`` and ``w2``, the hidden width padded
with zeros to a multiple of 8 (2730 to 2736) so that cuBLAS takes its
aligned kernels; the residual adds, with
drop path's scale, are ``ops.prefix_mask.branch_add`` (M2). Parameters are
float32, ``dtype`` the compute type. Departures: no dropout (the published
fine-tune trains at 0; a rate above 0 is refused); the model has no
``network_def`` and takes no masks: it trains dense.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.masked_layer_norm import masked_layer_norm
from ..ops.prefix_mask import branch_add, drop_path_scale
from ..ops.rope_attention import rope_attention
from ..ops.swiglu_ln import swiglu_ln
from .layers import linear, make_linear, trunc_normal_
from .patch_embed import PatchEmbed

LN_EPS = 1e-6
ROPE_THETA = 10000.0
PT_SEQ_LEN = 16          # the pretraining grid (224 px / 14) the rotary positions scale from
MLP_RATIO = 4 * 2 / 3
PITCH = 8                # the MLP's hidden width runs padded to a multiple of this


def rope_tables(grid: int, head_dim: int, pt_seq_len: int = PT_SEQ_LEN,
                theta: float = ROPE_THETA) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)``, float32 ``(1 + grid^2, head_dim)``: row 0 (the cls
    token) the identity, then EVA-02's ``VisionRotaryEmbeddingFast`` over the
    patch grid in raster order: ``head_dim / 4`` frequencies ``theta^(-2i /
    (head_dim / 2))``, each repeated twice, at positions ``arange(grid) / grid
    * pt_seq_len``; the row's in the first half of the columns, the
    column's in the second."""
    dim = head_dim // 2
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2)[:dim // 2].float() / dim)
    t = torch.arange(grid) / grid * pt_seq_len
    f = torch.einsum("i,f->if", t, freqs).repeat_interleave(2, dim=-1)
    f = torch.cat([f[:, None, :].expand(grid, grid, dim), f[None, :, :].expand(grid, grid, dim)],
                  dim=-1).reshape(grid * grid, head_dim)
    cos = torch.cat([torch.ones(1, head_dim), f.cos()])
    sin = torch.cat([torch.zeros(1, head_dim), f.sin()])
    return cos, sin


class LayerNorm(nn.Module):
    """``nn.LayerNorm``'s parameters, run as the port's dense layer norm."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return masked_layer_norm(x, self.weight, self.bias, None, LN_EPS)


def _bare_linear(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features, bias=False)
    with torch.no_grad():
        trunc_normal_(layer.weight, generator)
    return layer


class Attention(nn.Module):
    """Sub-LN rotary attention: ``proj(inner_attn_ln(attn(q, k, v)))``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.scale = (dim // num_heads) ** -0.5
        self.q_proj = _bare_linear(dim, dim, generator)
        self.k_proj = _bare_linear(dim, dim, generator)
        self.v_proj = _bare_linear(dim, dim, generator)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.inner_attn_ln = LayerNorm(dim)
        self.proj = make_linear(dim, dim, generator)

    def forward(self, x: torch.Tensor, tables) -> torch.Tensor:
        dt = self.dtype
        weight = torch.cat([m.weight.to(dt) for m in (self.q_proj, self.k_proj, self.v_proj)])
        bias = torch.cat([self.q_bias.to(dt), torch.zeros_like(self.v_bias, dtype=dt),
                          self.v_bias.to(dt)])
        qkv = F.linear(x.to(dt), weight, bias)
        out = rope_attention(qkv, tables, self.scale, self.num_heads)
        return linear(self.inner_attn_ln(out), self.proj, dt)


class SwiGLU(nn.Module):
    """``w3(ffn_ln(silu(w1 x) * w2 x))``. The hidden width runs padded with
    zeros to a multiple of 8 (2730 to 2736), so that the GEMMs on either
    side read and write rows on 16-byte boundaries: zero rows stacked under
    ``w1`` and ``w2``, zero columns beside ``w3``, and ``ops.swiglu_ln``
    writing zeros into the padding."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype, self.pad = dtype, -hidden % PITCH
        self.w1 = make_linear(dim, hidden, generator)
        self.w2 = make_linear(dim, hidden, generator)
        self.ffn_ln = LayerNorm(hidden)
        self.w3 = make_linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, pad = self.dtype, self.pad
        weights, biases = [], []
        for m in (self.w1, self.w2):
            weights.append(F.pad(m.weight.to(dt), (0, 0, 0, pad)))
            biases.append(F.pad(m.bias.to(dt), (0, pad)))
        u = F.linear(x.to(dt), torch.cat(weights), torch.cat(biases))
        h = swiglu_ln(u, self.ffn_ln.weight, self.ffn_ln.bias, LN_EPS)
        return F.linear(h, F.pad(self.w3.weight.to(dt), (0, pad)), self.w3.bias.to(dt))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden: int, drop_path_rate: float,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dtype, generator)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwiGLU(dim, hidden, dtype, generator)

    def _add(self, x, f, keeps, generator):
        """``x + f``, with drop path's per-example scale while training."""
        if not self.training or self.drop_path_rate == 0.0:
            return x + f
        keep = next(keeps) if keeps is not None else None
        scale = drop_path_scale(x.shape[0], self.drop_path_rate, x.device, keep, generator)
        return branch_add(x, f, None, scale)

    def forward(self, x, tables, keeps, generator):
        x = self._add(x, self.attn(self.norm1(x), tables), keeps, generator)
        return self._add(x, self.mlp(self.norm2(x)), keeps, generator)


class EVA02(nn.Module):
    """``model(images)`` with NHWC images returns the class logits.

    Built from ``seed`` on the CPU and moved to ``device`` (the CUDA device
    unless ``"cpu"``). Initialised as EVA-02's fine-tune model: linear
    weights, ``cls_token`` and ``pos_embed`` truncated normal at 0.02,
    biases 0, layer norms at 1 and 0, each block's ``attn.proj`` and
    ``mlp.w3`` weights divided by ``sqrt(2 * (i + 1))``, the head's weight
    scaled by 0.001. ``drop_path_rate`` rises linearly over the blocks, one
    rate per block for both branches. ``gelu`` is taken for the CLI's common
    arguments and not used (the MLP gates with SiLU).
    """

    network_def = None

    def __init__(self, img_size: int = 448, patch_size: int = 14, num_classes: int = 1000,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = MLP_RATIO, drop_path_rate: float = 0.0,
                 dropout_rate: float = 0.0, gelu: str = "exact",
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        if dropout_rate > 0.0:
            raise NotImplementedError("EVA-02 is ported without dropout (its published "
                                      "fine-tune trains at 0)")
        if img_size % patch_size or embed_dim % num_heads or (embed_dim // num_heads) % 4:
            raise ValueError(f"EVA-02 needs whole patches and a head dim divisible by 4: "
                             f"{img_size} px, patch {patch_size}, {embed_dim} / {num_heads}")
        device = resolve_device(device)
        self.img_size, self.patch_size, self.dtype = img_size, patch_size, dtype
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.num_classes = num_classes
        self.hidden = int(embed_dim * mlp_ratio)
        grid = img_size // patch_size
        gen = torch.Generator().manual_seed(seed)
        self.patch_embed = PatchEmbed(img_size, patch_size, embed_dim, dtype, gen)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, embed_dim))
        rates = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, self.hidden, float(rates[i]),
                                           dtype, gen) for i in range(depth)])
        self.fc_norm = LayerNorm(embed_dim)
        self.head = make_linear(embed_dim, num_classes, gen)
        cos, sin = rope_tables(grid, embed_dim // num_heads)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        with torch.no_grad():
            trunc_normal_(self.cls_token, gen)
            trunc_normal_(self.pos_embed, gen)
            for i, block in enumerate(self.blocks):
                block.attn.proj.weight.div_(math.sqrt(2.0 * (i + 1)))
                block.mlp.w3.weight.div_(math.sqrt(2.0 * (i + 1)))
            self.head.weight.mul_(0.001)
        self.to(device)

    def no_weight_decay_keywords(self) -> Tuple[str, ...]:
        """Names left out of weight decay beside rank-1 leaves (EVA-02's
        ``no_weight_decay``)."""
        return ("pos_embed", "cls_token")

    def layer_id(self, name: str) -> int:
        """The layer of a parameter for layer-wise learning-rate decay, as
        EVA-02's ``get_num_layer_for_vit``: the stem, ``cls_token`` and
        ``pos_embed`` 0, block ``i`` ``i + 1``, the rest (``fc_norm``, the
        head) ``depth + 1``."""
        if name.startswith(("patch_embed.", "cls_token", "pos_embed")):
            return 0
        if name.startswith("blocks."):
            return int(name.split(".")[1]) + 1
        return self.depth + 1

    def forward(self, x: torch.Tensor, masks: Optional[Dict] = None,
                patch_output_type: Optional[str] = None,
                drop_keeps: Optional[Iterable[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_keeps: Optional[Iterable[torch.Tensor]] = None) -> torch.Tensor:
        """``drop_keeps``: stochastic-depth keep draws in call order (each
        block whose rate is above 0: its attention branch, then its MLP
        branch); ``None`` draws them from ``generator``. ``masks`` must be
        ``None``: the model trains dense."""
        if masks is not None:
            raise ValueError("EVA-02 takes no architecture masks")
        keeps = None if drop_keeps is None else iter(drop_keeps)
        dt = self.dtype
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.to(dt).expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed.to(dt)
        tables = (self.rope_cos, self.rope_sin)
        for block in self.blocks:
            x = block(x, tables, keeps, generator)
        x = self.fc_norm(x[:, 1:].mean(1, keepdim=True))[:, 0]
        return linear(x, self.head, dt)

    def dropout_shapes(self, batch: int) -> List[tuple]:
        return []
