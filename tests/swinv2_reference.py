"""Plain float32 forward of SwinV2 (Liu et al., arXiv:2111.09883).

Written from the published equations of ``models/swin_transformer_v2.py``
(github.com/microsoft/Swin-Transformer) in plain PyTorch: explicit ``(nW,
N, N)`` shift masks built as that file builds them, an explicit ``(H, N,
N)`` position bias, softmax over materialised scores. Parameters are read
from a dict keyed by that file's state-dict names. Nothing here imports the
program under test or JAX.

Every matrix product and convolution takes its operands through ``quant``,
and so does the residual stream after the stem, after every block and after
every patch merging (identity for the reference; a control's lower
precision rounds there what a lower-precision program would store).

Departures from the published module, none of which changes the function:
the model is a function of a parameter dict, not an ``nn.Module``; dropout
is left out (its rates are 0); stochastic depth takes its per-example keep
draws as inputs; the tables are rebuilt at each call. TF32 is off while it
runs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
MASK_FILL = -100.0
MAX_LOGIT_SCALE = math.log(1.0 / 0.01)
SWINV2_BASE_W16_256 = {"img_size": 256, "patch_size": 4, "embed_dim": 128,
                       "depths": (2, 2, 18, 2), "num_heads": (4, 8, 16, 32),
                       "window_size": 16, "mlp_ratio": 4.0}


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def linear(x, P, name, quant):
    return F.linear(quant(x), quant(P[name + ".weight"]), P.get(name + ".bias"))


def layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], LN_EPS)


def drop_path(x, keep, rate):
    if keep is None or rate == 0.0:
        return x
    return x * keep.view(-1, 1, 1).float() / (1.0 - rate)


def drop_path_rates(depths: Sequence[int], rate: float):
    """One rate per block, rising linearly from 0 to ``rate``."""
    return [float(r) for r in np.linspace(0.0, rate, sum(depths))]


def drop_path_draws(depths: Sequence[int], rate: float):
    """The rate of each stochastic-depth draw of one forward, in call order:
    two per block whose rate is above 0."""
    return [r for r in drop_path_rates(depths, rate) if r > 0.0 for _ in range(2)]


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def attn_mask(r, ws, shift):
    """Swin's ``(nW, N, N)`` mask of a shifted block: -100 between tokens of
    different regions."""
    img_mask = torch.zeros((1, r, r, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASK_FILL).masked_fill(mask == 0, 0.0)


def coords_table(ws):
    """``(1, 2ws - 1, 2ws - 1, 2)``: relative offsets over ``ws - 1``, times
    8, then ``sign(t) * log2(1 + |t|) / log2(8)``."""
    rel = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    table = torch.stack(torch.meshgrid([rel, rel], indexing="ij")).permute(1, 2, 0)
    table = table.contiguous().unsqueeze(0)
    table[:, :, :, 0] /= ws - 1
    table[:, :, :, 1] /= ws - 1
    table *= 8
    return torch.sign(table) * torch.log2(torch.abs(table) + 1.0) / np.log2(8)


def position_index(ws):
    """``(N, N)`` index of each (query, key) pair into the table."""
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def position_bias(P, name, ws, heads, device):
    """The ``(H, N, N)`` continuous position bias: ``16 * sigmoid`` of the
    MLP's table at the relative index."""
    hidden = F.relu(F.linear(coords_table(ws).to(device), P[name + ".cpb_mlp.0.weight"],
                             P[name + ".cpb_mlp.0.bias"]))
    table = F.linear(hidden, P[name + ".cpb_mlp.2.weight"]).view(-1, heads)
    n = ws * ws
    bias = table[position_index(ws).to(device).view(-1)].view(n, n, -1)
    return 16 * torch.sigmoid(bias.permute(2, 0, 1).contiguous())


def window_attention(x, P, name, heads, ws, mask, quant):
    b_, n, c = x.shape
    qkv_bias = torch.cat((P[name + ".q_bias"], torch.zeros_like(P[name + ".v_bias"]),
                          P[name + ".v_bias"]))
    qkv = F.linear(quant(x), quant(P[name + ".qkv.weight"]), qkv_bias)
    q, k, v = qkv.reshape(b_, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    attn = quant(F.normalize(q, dim=-1)) @ quant(F.normalize(k, dim=-1)).transpose(-2, -1)
    logit_scale = torch.clamp(P[name + ".logit_scale"], max=MAX_LOGIT_SCALE).exp()
    attn = attn * logit_scale + position_bias(P, name, ws, heads, x.device).unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = (quant(attn) @ quant(v)).transpose(1, 2).reshape(b_, n, c)
    return linear(out, P, name + ".proj", quant)


def block(x, P, name, r, heads, ws, shift, keeps, rate, quant):
    """Res-post-norm: ``x + drop_path(norm1(attn(x)))``, then ``x +
    drop_path(norm2(mlp(x)))``; ``keeps`` the two branches' draws or None."""
    if r <= ws:
        ws, shift = r, 0
    b, l, c = x.shape
    h = x.view(b, r, r, c)
    if shift > 0:
        h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(h, ws).view(-1, ws * ws, c)
    mask = attn_mask(r, ws, shift).to(x.device) if shift > 0 else None
    a = window_attention(windows, P, name + ".attn", heads, ws, mask, quant)
    h = window_reverse(a.view(-1, ws, ws, c), ws, r, r)
    if shift > 0:
        h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
    h = h.reshape(b, l, c)
    k0, k1 = keeps if keeps is not None else (None, None)
    x = quant(x + drop_path(layer_norm(h, P, name + ".norm1"), k0, rate))
    m = linear(F.gelu(linear(x, P, name + ".mlp.fc1", quant)), P, name + ".mlp.fc2", quant)
    return quant(x + drop_path(layer_norm(m, P, name + ".norm2"), k1, rate))


def patch_merging(x, P, name, r, quant):
    b, _, c = x.shape
    x = x.view(b, r, r, c)
    x = torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :], x[:, 0::2, 1::2, :],
                   x[:, 1::2, 1::2, :]], -1).view(b, -1, 4 * c)
    return layer_norm(linear(x, P, name + ".reduction", quant), P, name + ".norm")


def forward(P: Dict[str, torch.Tensor], images: torch.Tensor, cfg: Dict,
            keeps: Optional[Sequence[torch.Tensor]] = None, drop_path_rate: float = 0.0,
            quant: Callable = identity) -> torch.Tensor:
    """Logits of normalised NHWC ``images``. ``keeps``: the stochastic-depth
    keep draws in the order of ``drop_path_draws`` (each block whose rate is
    above 0: its attention branch, then its MLP branch), or None for none."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        patch, ws = cfg["patch_size"], cfg["window_size"]
        x = F.conv2d(quant(images.permute(0, 3, 1, 2)), quant(P["patch_embed.proj.weight"]),
                     P["patch_embed.proj.bias"], stride=patch)
        x = quant(layer_norm(x.flatten(2).transpose(1, 2), P, "patch_embed.norm"))
        r, j, drawn = cfg["img_size"] // patch, 0, 0
        rates = drop_path_rates(cfg["depths"], drop_path_rate)
        for i, depth in enumerate(cfg["depths"]):
            for bi in range(depth):
                kk = None
                if keeps is not None and rates[j] > 0.0:
                    kk = (keeps[drawn], keeps[drawn + 1])
                    drawn += 2
                x = block(x, P, f"layers.{i}.blocks.{bi}", r, cfg["num_heads"][i], ws,
                          0 if bi % 2 == 0 else ws // 2, kk, rates[j], quant)
                j += 1
            if i < len(cfg["depths"]) - 1:
                x = quant(patch_merging(x, P, f"layers.{i}.downsample", r, quant))
                r //= 2
        x = layer_norm(x, P, "norm").mean(1)
        return linear(x, P, "head", quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
