"""SwinV2: a multi-stage vision transformer of shifted windows.

Port of ``models/swin_transformer_v2.py`` of github.com/microsoft/Swin-Transformer
(Liu et al., "Swin Transformer V2: Scaling Up Capacity and Resolution",
arXiv:2111.09883), not of the JAX package, which has no Swin. Parameter
names follow that file's state dict (``layers.{i}.blocks.{j}.attn.cpb_mlp.0.weight``,
``.attn.logit_scale``, ``.attn.q_bias``, ``layers.{i}.downsample.reduction.weight``,
...). Its parts:

- a conv 4 x 4 / 4 stem, then a layer norm;
- stages of blocks, each ``x + drop_path(norm1(attn(x)))`` then ``x +
  drop_path(norm2(mlp(x)))`` (res-post-norm), the attention in windows of
  ``ws x ws`` tokens, every second block of a stage shifted by ``ws // 2``
  (a cyclic roll, and -100 between tokens of different regions); a stage
  whose resolution is at most ``ws`` is one window and never shifted;
- scaled cosine attention (``ops.window_attention``) with a per-head
  ``logit_scale`` clamped at ln 100, ``q_bias`` and ``v_bias``, and a
  continuous position bias: the log-spaced relative coordinates through
  ``cpb_mlp`` (2 -> 512 -> H), gathered by the relative index, ``16 *
  sigmoid``;
- patch merging between stages: the 2 x 2 neighbours concatenated (4C),
  ``Linear(4C, 2C, no bias)``, then a layer norm;
- a final layer norm, the mean over tokens and the head.

Every layer norm is ``masked_layer_norm(mask=None)`` at eps 1e-5 (on the
card, K3/K4's dense mode). Parameters are float32, ``dtype`` the compute
type; the position bias and the scale stay in float32. Departures: no
dropout (the published configurations train at 0; a rate above 0 is
refused), and the bias MLP runs in float32 where Swin's fp16 AMP runs it in
fp16. The model has no ``network_def`` and takes no masks: it trains dense.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.drop_path import drop_path
from ..ops.masked_layer_norm import masked_layer_norm
from ..ops.window_attention import window_attention
from ..utils.trace import span
from .layers import GELU_FORMS, linear, make_linear, trunc_normal_
from .patch_embed import conv2d

LN_EPS = 1e-5
MAX_LOGIT_SCALE = math.log(1.0 / 0.01)
CPB_HIDDEN = 512
BIAS_RANGE = 16.0


class LayerNorm(nn.Module):
    """``nn.LayerNorm``'s parameters, run as the port's dense layer norm."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return masked_layer_norm(x, self.weight, self.bias, None, LN_EPS)


# --- windows, shifts and the relative position tables ------------------------

def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``(B, R, R, C)`` -> ``(B * nW, ws * ws, C)``, windows in raster order."""
    b, r, _, c = x.shape
    x = x.view(b, r // ws, ws, r // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, r: int) -> torch.Tensor:
    """``(B * nW, ws * ws, C)`` -> ``(B, R, R, C)``."""
    c = windows.shape[-1]
    x = windows.view(-1, r // ws, r // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, r, r, c)


def to_windows(x: torch.Tensor, r: int, ws: int, shift: int) -> torch.Tensor:
    """``(B, R * R, C)`` tokens, rolled by ``-shift``, to ``(B * nW, ws * ws, C)``."""
    b, _, c = x.shape
    h = x.view(b, r, r, c)
    if shift:
        h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
    return window_partition(h, ws)


def from_windows(w: torch.Tensor, r: int, ws: int, shift: int) -> torch.Tensor:
    """:func:`to_windows`'s inverse."""
    h = window_reverse(w, ws, r)
    if shift:
        h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
    return h.reshape(h.shape[0], r * r, -1)


class _Windows(torch.autograd.Function):
    """:func:`to_windows` (or, ``inverse``, :func:`from_windows`), and the
    other as its backward: both ways under the span ``vst.swin.window``,
    the backward's on the thread autograd runs it on."""

    @staticmethod
    def forward(ctx, x, r, ws, shift, inverse):
        ctx.geometry = (r, ws, shift, inverse)
        with span("vst.swin.window"):
            return (from_windows if inverse else to_windows)(x, r, ws, shift)

    @staticmethod
    def backward(ctx, g):
        r, ws, shift, inverse = ctx.geometry
        with span("vst.swin.window"):
            return (to_windows if inverse else from_windows)(g, r, ws, shift), None, None, None, None


def position_bias(w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, coords: torch.Tensor,
                  index: torch.Tensor) -> torch.Tensor:
    """``16 * sigmoid`` of the bias MLP's ``(2ws - 1)^2`` table, gathered by
    ``index`` into ``(H, N, N)``."""
    n = index.shape[0]
    table = F.linear(F.relu(F.linear(coords, w0, b0)), w2).view(-1, w2.shape[0])
    return BIAS_RANGE * torch.sigmoid(table[index.reshape(-1)].view(n, n, -1).permute(2, 0, 1))


class _PositionBias(torch.autograd.Function):
    """:func:`position_bias` under the span ``vst.swin.bias``; the backward
    recomputes it (a few thousand entries) under the same span."""

    @staticmethod
    def forward(ctx, w0, b0, w2, coords, index):
        ctx.save_for_backward(w0, b0, w2, coords, index)
        with span("vst.swin.bias"):
            return position_bias(w0, b0, w2, coords, index).contiguous()

    @staticmethod
    def backward(ctx, g):
        w0, b0, w2, coords, index = ctx.saved_tensors
        with span("vst.swin.bias"), torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (w0, b0, w2)]
            grads = torch.autograd.grad(position_bias(*leaves, coords, index), leaves, g)
        return (*grads, None, None)


def shift_regions(r: int, ws: int, shift: int) -> torch.Tensor:
    """Each token's region id in its window, ``(nW, ws * ws)`` int32: the
    nine regions of Swin's ``img_mask`` after the roll by ``-shift``."""
    img = torch.zeros((1, r, r, 1))
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img[:, hs, wsl, :] = cnt
            cnt += 1
    return window_partition(img, ws).view(-1, ws * ws).to(torch.int32)


def relative_coords_table(ws: int) -> torch.Tensor:
    """``(2ws - 1, 2ws - 1, 2)`` relative offsets scaled to +-8, then
    ``sign(t) * log2(1 + |t|) / log2(8)``."""
    h = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    table = torch.stack(torch.meshgrid([h, h], indexing="ij")).permute(1, 2, 0)
    table = table / (ws - 1) * 8.0
    return torch.sign(table) * torch.log2(table.abs() + 1.0) / np.log2(8)


def relative_position_index(ws: int) -> torch.Tensor:
    """``(N, N)`` index of each (query, key) pair into the flattened table."""
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    return (rel[..., 0] + ws - 1) * (2 * ws - 1) + rel[..., 1] + ws - 1


class _Tables:
    """The constant tables of a window size, built once per device."""

    def __init__(self, ws: int, shift: int, r: int):
        self.ws, self.shift, self.r = ws, shift, r
        self._by_device: Dict[torch.device, Tuple] = {}

    def get(self, device: torch.device):
        got = self._by_device.get(device)
        if got is None:
            regions = (shift_regions(self.r, self.ws, self.shift).to(device)
                       if self.shift else None)
            got = (relative_coords_table(self.ws).to(device),
                   relative_position_index(self.ws).to(device), regions)
            self._by_device[device] = got
        return got


# --- modules -------------------------------------------------------------------

class WindowAttention(nn.Module):
    """Scaled cosine attention in windows with the continuous position bias."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones((num_heads, 1, 1))))
        self.cpb_mlp = nn.Sequential(make_linear(2, CPB_HIDDEN, generator), nn.ReLU(),
                                     nn.Linear(CPB_HIDDEN, num_heads, bias=False))
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = make_linear(dim, dim, generator)
        with torch.no_grad():
            trunc_normal_(self.cpb_mlp[2].weight, generator)
            trunc_normal_(self.qkv.weight, generator)

    def forward(self, x: torch.Tensor, tables: Tuple) -> torch.Tensor:
        coords, index, regions = tables
        qkv_bias = torch.cat((self.q_bias, torch.zeros_like(self.v_bias), self.v_bias))
        qkv = F.linear(x.to(self.dtype), self.qkv.weight.to(self.dtype), qkv_bias.to(self.dtype))
        scale = torch.clamp(self.logit_scale, max=MAX_LOGIT_SCALE).exp().view(self.num_heads)
        bias = _PositionBias.apply(self.cpb_mlp[0].weight, self.cpb_mlp[0].bias,
                                   self.cpb_mlp[2].weight, coords, index)
        out = window_attention(qkv, scale, bias, regions, self.num_heads)
        return linear(out, self.proj, self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu: str, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.gelu, self.dtype = gelu, dtype
        self.fc1 = make_linear(dim, hidden, generator)
        self.fc2 = make_linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(linear(x, self.fc1, self.dtype),
                   approximate="tanh" if self.gelu == "tanh" else "none")
        return linear(x, self.fc2, self.dtype)


class SwinTransformerBlock(nn.Module):
    """Res-post-norm block on a ``(B, R * R, C)`` token grid."""

    def __init__(self, dim: int, resolution: int, num_heads: int, ws: int, shift: int,
                 mlp_ratio: float, drop_path_rate: float, gelu: str, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        if resolution <= ws:   # one window holds the stage: no partition, no shift
            ws, shift = resolution, 0
        if resolution % ws:
            raise ValueError(f"resolution {resolution} is not whole windows of {ws}")
        self.resolution, self.ws, self.shift = resolution, ws, shift
        self.drop_path_rate = drop_path_rate
        self.attn = WindowAttention(dim, num_heads, dtype, generator)
        self.norm1 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu, dtype, generator)
        self.norm2 = LayerNorm(dim)
        self.tables = _Tables(ws, shift, resolution)

    def _drop_path(self, x, keeps, generator):
        if not self.training or self.drop_path_rate == 0.0:
            return x
        keep = next(keeps) if keeps is not None else None
        return drop_path(x, self.drop_path_rate, True, keep=keep, generator=generator)

    def forward(self, x: torch.Tensor, keeps: Optional[Iterable[torch.Tensor]],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        r, ws, shift = self.resolution, self.ws, self.shift
        windows = _Windows.apply(x, r, ws, shift, False)
        h = _Windows.apply(self.attn(windows, self.tables.get(x.device)), r, ws, shift, True)
        x = x + self._drop_path(self.norm1(h), keeps, generator)
        return x + self._drop_path(self.norm2(self.mlp(x)), keeps, generator)


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated (4C), reduced to 2C, then a layer norm."""

    def __init__(self, resolution: int, dim: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.resolution, self.dtype = resolution, dtype
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim)
        with torch.no_grad():
            trunc_normal_(self.reduction.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        r = self.resolution
        x = x.view(b, r, r, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1).reshape(b, -1, 4 * c)
        return self.norm(linear(x, self.reduction, self.dtype))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, resolution: int, depth: int, num_heads: int, ws: int,
                 mlp_ratio: float, rates: Sequence[float], downsample: bool, gelu: str,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, resolution, num_heads, ws, 0 if i % 2 == 0 else ws // 2,
                                 mlp_ratio, float(rates[i]), gelu, dtype, generator)
            for i in range(depth)])
        self.downsample = (PatchMerging(resolution, dim, dtype, generator) if downsample
                           else None)

    def forward(self, x, keeps, generator):
        for block in self.blocks:
            x = block(x, keeps, generator)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim)
        with torch.no_grad():
            trunc_normal_(self.proj.weight, generator)
            self.proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(x.permute(0, 3, 1, 2), self.proj, self.dtype)
        return self.norm(x.flatten(2).transpose(1, 2).contiguous())


class SwinTransformerV2(nn.Module):
    """``model(images)`` with NHWC images returns the class logits.

    Built from ``seed`` on the CPU and moved to ``device`` (the CUDA device
    unless ``"cpu"``). Initialised as Swin's ``_init_weights`` and
    ``_init_respostnorm`` do: linear weights truncated normal at 0.02,
    biases 0, every block's ``norm1`` and ``norm2`` at weight 0 and bias 0,
    ``logit_scale`` at ln 10. ``drop_path_rate`` rises linearly over the
    blocks, one rate per block for both branches.
    """

    network_def = None

    def __init__(self, img_size: int = 256, patch_size: int = 4, num_classes: int = 1000,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 16,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.5, dropout_rate: float = 0.0,
                 gelu: str = "exact", dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        if dropout_rate > 0.0:
            raise NotImplementedError("SwinV2 is ported without dropout (its published "
                                      "configurations train at 0)")
        if gelu not in GELU_FORMS:
            raise ValueError(f"gelu must be one of {GELU_FORMS}, got {gelu!r}")
        device = resolve_device(device)
        self.img_size, self.patch_size, self.dtype = img_size, patch_size, dtype
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        self.num_heads, self.window_size = tuple(num_heads), window_size
        self.mlp_ratio, self.num_classes = mlp_ratio, num_classes
        gen = torch.Generator().manual_seed(seed)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype, gen)
        rates = np.linspace(0.0, drop_path_rate, sum(depths))
        layers, resolution, at = [], img_size // patch_size, 0
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            layers.append(BasicLayer(dim, resolution, depth, num_heads[i], window_size,
                                     mlp_ratio, rates[at:at + depth], i < len(depths) - 1,
                                     gelu, dtype, gen))
            at += depth
            resolution //= 2
        self.layers = nn.ModuleList(layers)
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(self.num_features)
        self.head = make_linear(self.num_features, num_classes, gen)
        with torch.no_grad():
            for layer in self.layers:
                for block in layer.blocks:
                    for norm in (block.norm1, block.norm2):
                        norm.weight.zero_()
                        norm.bias.zero_()
        self.to(device)

    def no_weight_decay_keywords(self) -> Tuple[str, ...]:
        """Names left out of weight decay beside rank-1 leaves (Swin's
        ``no_weight_decay_keywords``)."""
        return ("cpb_mlp", "logit_scale")

    def forward(self, x: torch.Tensor, masks: Optional[Dict] = None,
                patch_output_type: Optional[str] = None,
                drop_keeps: Optional[Iterable[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_keeps: Optional[Iterable[torch.Tensor]] = None) -> torch.Tensor:
        """``drop_keeps``: stochastic-depth keep draws in call order (each
        block's attention branch, then its MLP branch); ``None`` draws them
        from ``generator``. ``masks`` must be ``None`` and ``dropout_keeps``
        empty: the model trains dense and without dropout."""
        if masks is not None:
            raise ValueError("SwinV2 takes no architecture masks")
        keeps = None if drop_keeps is None else iter(drop_keeps)
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, keeps, generator)
        x = self.norm(x).mean(1)
        return linear(x, self.head, self.dtype)

    def dropout_shapes(self, batch: int) -> List[tuple]:
        return []

