"""Plain float32 forward of a ViT-ResNAS network (ViT-SR, patch 14).

Written from the published description (ViT-ResNAS, "Searching for
Efficient Multi-Stage Vision Transformers", yilunliao/vit-search) in plain
PyTorch: no kernels, no caching, no batching tricks. Parameters are read
from a dict keyed by the reference torch state-dict names. Nothing here
imports the program under test.

Every matrix product and convolution takes its operands through ``quant``,
and so does the residual stream after the stem and after every block
(identity for the reference; the control's lower precision rounds there
what a lower-precision program would store).

Supernet channel masks are built here from per-architecture keep counts:
example ``b`` of a batch takes architecture ``b % A``, a mask keeps a prefix
of channels, a layer mask is all-or-nothing per example. Masked layer norm
corrects its statistics for the zeroed channels.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LINEAR_EMBED, TRANSFORMER, HEAD, SPATIAL_REDUCTION, CONV_EMBED, FLEX_CONV_EMBED = range(6)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6
BN_EPS = 1e-5


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


# --- masks ------------------------------------------------------------------

def mask_sites(network_def: Sequence, space: Sequence) -> List[tuple]:
    """The keep-count sites in packed order: the stem's embed, then each
    slot in order with its keys sorted; ``(path, width)``."""
    sites = [(("embed",), network_def[0][1])]
    for slot, (block, keep) in enumerate(zip(network_def, space)):
        if block[0] == SPATIAL_REDUCTION:
            sites.append((("slots", slot, "embed"), block[2]))
        elif block[0] == TRANSFORMER:
            (embed, heads, head_dim), (_, hidden) = block[1], block[2]
            widths = {"attn": heads * head_dim, "mlp": hidden, "layer": embed}
            keys = sorted(k for k in widths if k != "layer" or keep.get("layer") is not None)
            sites += [(("slots", slot, k), widths[k]) for k in keys]
    return sites


def masks_from_packed(packed: torch.Tensor, network_def: Sequence, space: Sequence,
                      batch: int, archs: int) -> Dict:
    """Mask tree ``{"embed": (B, 1, E), "slots": {slot: {key: (B, 1, W)}}}``
    of float 0/1 masks from a packed vector of ``archs`` counts per site."""
    masks: Dict = {"embed": None, "slots": {}}
    rows = torch.arange(batch, device=packed.device) % archs
    for i, (path, width) in enumerate(mask_sites(network_def, space)):
        counts = packed[i * archs:(i + 1) * archs].long()[rows]
        mask = (torch.arange(width, device=packed.device).view(1, 1, -1)
                < counts.view(-1, 1, 1)).float()
        if path == ("embed",):
            masks["embed"] = mask
        else:
            masks["slots"].setdefault(path[1], {})[path[2]] = mask
    if len(packed) != len(mask_sites(network_def, space)) * archs:
        raise ValueError("packed counts do not fit the network's sites")
    return masks


# --- layers -----------------------------------------------------------------

def linear(x, P, name, quant):
    return F.linear(quant(x), quant(P[name + ".weight"]), P.get(name + ".bias"))


def conv(x, P, name, stride, padding, quant):
    return F.conv2d(quant(x), quant(P[name + ".weight"]), P.get(name + ".bias"),
                    stride, padding)


def layer_norm(x, P, name, mask):
    w, b = P[name + ".weight"], P[name + ".bias"]
    if mask is None:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + LN_EPS) * w + b
    inv_p = 1.0 / mask.mean(-1, keepdim=True)
    mu = x.mean(-1, keepdim=True) * inv_p
    var = (x * x).mean(-1, keepdim=True) * inv_p - mu * mu
    return (w * ((x - mu) * torch.rsqrt(var + LN_EPS)) + b) * mask


def batch_norm(x, P, name, train=True):
    """Batch norm over NCHW: in training the batch's statistics (biased
    variance E[x^2] - E[x]^2), else the running ones."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    mul = torch.rsqrt(var + BN_EPS) * P[name + ".weight"]
    shift = P[name + ".bias"].view(1, -1, 1, 1)
    return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + shift


def apply_mask(x, mask):
    return x if mask is None else x * mask


def and_mask(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a * b


def attention(x, P, name, heads, head_dim, quant):
    b, n, _ = x.shape
    qkv = linear(x, P, name + ".qkv", quant).view(b, n, 3, heads, head_dim)
    q, k, v = qkv.unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", quant(q), quant(k)) * head_dim ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", quant(p), quant(v)).reshape(b, n, heads * head_dim)


def drop_path(x, keep, rate):
    if keep is None:
        return x
    return torch.where(keep.view(-1, 1, 1), x / (1.0 - rate), torch.zeros_like(x))


def block(x, P, name, spec, embed_mask, layer_mask, masks, keeps, rate, quant, gelu):
    (_, heads, head_dim), (_, _) = spec[1], spec[2]
    masks = masks or {}
    own = masks.get("layer")
    f = attention(layer_norm(x, P, name + ".norm1", embed_mask), P, name + ".attn",
                  heads, head_dim, quant)
    f = linear(apply_mask(f, masks.get("attn")), P, name + ".attn.proj", quant)
    f = drop_path(f, keeps[0], rate)
    current = None
    if own is not None:
        f = f * own
        current = and_mask(own, layer_mask)
    if embed_mask is not None:
        current = and_mask(current, embed_mask)
        f = f * current
    x = x + f
    h = linear(layer_norm(x, P, name + ".norm2", embed_mask), P, name + ".mlp.fc1", quant)
    h = F.gelu(h, approximate="tanh" if gelu == "tanh" else "none")
    f = linear(apply_mask(h, masks.get("mlp")), P, name + ".mlp.fc2", quant)
    f = drop_path(f, keeps[1], rate)
    return x + apply_mask(f, current), current


def sr_block(x, P, name, grid, c_in, c_out, tokens, embed_mask, out_mask, quant):
    b = x.shape[0]
    normed = layer_norm(x, P, name + ".norm", embed_mask)
    g = normed[:, tokens:].reshape(b, grid, grid, c_in).permute(0, 3, 1, 2)
    patches = conv(g, P, name + ".patch_reduce", 2, 1, quant).flatten(2).transpose(1, 2)
    patches = patches + P[name + ".pos_embed"]
    res = x[:, tokens:].reshape(b, grid, grid, c_in).permute(0, 3, 1, 2)
    res = F.avg_pool2d(res, 2, 2).flatten(2).transpose(1, 2)
    tok = linear(normed[:, :tokens], P, name + ".token_transform", quant)
    out = torch.cat([tok, patches], dim=1)
    residual = F.pad(torch.cat([x[:, :tokens], res], dim=1), (0, c_out - c_in))
    return apply_mask(out + residual, out_mask)


def stem(x, P, network_def, patch_size, quant, train=True):
    """NHWC float images -> (B, N, E) patch tokens."""
    x = x.permute(0, 3, 1, 2)
    kind = network_def[0][0]
    if kind == LINEAR_EMBED:
        return conv(x, P, "patch_embed.proj", patch_size, 0, quant).flatten(2).transpose(1, 2)

    def cba(x, name, stride):
        return F.relu(batch_norm(conv(x, P, name + ".conv", stride, 1, quant), P, name + ".bn",
                                 train))

    x = cba(x, "patch_embed.conv1", 2)
    x = cba(cba(x, "patch_embed.conv2", 1), "patch_embed.conv3", 1) + x
    half = patch_size // 2
    return conv(x, P, "patch_embed.conv_proj", half, 0, quant).flatten(2).transpose(1, 2)


def forward(P: Dict[str, torch.Tensor], network_def: Sequence, images: torch.Tensor,
            masks: Optional[Dict], keeps: Optional[List[torch.Tensor]], drop_path_rate: float,
            patch_size: int = 14, gelu: str = "exact", patch_output: bool = True,
            quant: Callable = identity, remat: bool = True, train: bool = True):
    """Train-mode forward of normalized NHWC ``images``: ``(cls_logits,
    patch_logits)`` with ``patch_output``, else ``cls_logits``. ``keeps``
    holds the stochastic-depth keep draws in call order (each block's
    attention branch, then its MLP branch; a block at rate 0 draws none).
    ``remat`` recomputes each block in the backward, so a whole batch fits.
    Without ``train`` the stem's batch norms take their running statistics
    and the class logits alone come back.
    """
    tokens = 1
    x = stem(images, P, network_def, patch_size, quant, train)
    b = x.shape[0]
    x = quant(torch.cat([P["tokens"].expand(b, -1, -1), x], dim=1) + P["pos_embed"])
    masks = masks or {"embed": None, "slots": {}}
    embed_mask = masks.get("embed")
    x = apply_mask(x, embed_mask)
    grid = images.shape[1] // patch_size
    rates = block_rates(network_def, drop_path_rate)
    keeps = list(keeps or [])
    d, layer_mask = 0, None
    for slot, blk in enumerate(network_def[1:-1], start=1):
        name = f"blocks.{slot - 1}"
        site = masks["slots"].get(slot)
        if blk[0] == TRANSFORMER:
            if not blk[3]:
                layer_mask = None
                continue
            rate = rates[d]
            kk = (None, None)
            if rate > 0.0 and keeps:
                kk, keeps = (keeps[0], keeps[1]), keeps[2:]
            fn = (lambda x, name=name, blk=blk, em=embed_mask, lm=layer_mask, site=site,
                  kk=kk, rate=rate: block(x, P, name, blk, em, lm, site, kk, rate, quant, gelu))
            if remat and torch.is_grad_enabled():
                x, layer_mask = checkpoint(fn, x, use_reentrant=False)
            else:
                x, layer_mask = fn(x)
            x = quant(x)
            d += 1
        else:
            out_mask = (site or {}).get("embed")
            x = quant(sr_block(x, P, name, grid, blk[1], blk[2], tokens, embed_mask, out_mask,
                               quant))
            embed_mask, layer_mask = out_mask, None
            grid //= 2
    if keeps:
        raise ValueError(f"{len(keeps)} stochastic-depth keeps left unused")
    x = layer_norm(x, P, "norm", embed_mask)
    cls = linear(x[:, 0], P, "cls_head", quant)
    if patch_output and train:
        return cls, linear(x[:, tokens:], P, "patch_head", quant)
    return cls


def subnet(P: Dict[str, torch.Tensor], candidate: Sequence) -> Dict[str, torch.Tensor]:
    """The weights of ``candidate``, a sub-network of the supernet whose
    weights are ``P``: every width a prefix of the supernet's (heads a prefix
    of each of q, k and v), a removed block's weights dropped."""
    e = candidate[0][1]
    S = {"tokens": P["tokens"][..., :e], "pos_embed": P["pos_embed"][..., :e],
         "patch_embed.conv_proj.weight": P["patch_embed.conv_proj.weight"][:e],
         "patch_embed.conv_proj.bias": P["patch_embed.conv_proj.bias"][:e]}
    S.update({n: t for n, t in P.items()
              if n.startswith("patch_embed.conv") and not n.startswith("patch_embed.conv_proj")})

    def take(name, rows=None, cols=None):
        t = P[name]
        if rows is not None:
            t = t[rows] if isinstance(rows, torch.Tensor) else t[:rows]
        if cols is not None:
            t = t[:, :cols]
        S[name] = t

    for slot, blk in enumerate(candidate[1:-1], start=1):
        name = f"blocks.{slot - 1}"
        if blk[0] == TRANSFORMER:
            if not blk[3]:
                continue
            (e, heads, head_dim), (_, hidden) = blk[1], blk[2]
            full = P[name + ".attn.qkv.weight"].shape[0] // 3
            rows = torch.cat([t * full + torch.arange(heads * head_dim, device=P["tokens"].device)
                              for t in range(3)])
            for ln in (".norm1", ".norm2"):
                take(name + ln + ".weight", e)
                take(name + ln + ".bias", e)
            take(name + ".attn.qkv.weight", rows, e)
            take(name + ".attn.qkv.bias", rows)
            take(name + ".attn.proj.weight", e, heads * head_dim)
            take(name + ".attn.proj.bias", e)
            take(name + ".mlp.fc1.weight", hidden, e)
            take(name + ".mlp.fc1.bias", hidden)
            take(name + ".mlp.fc2.weight", e, hidden)
            take(name + ".mlp.fc2.bias", e)
        else:
            c_in, c_out = blk[1], blk[2]
            take(name + ".norm.weight", c_in)
            take(name + ".norm.bias", c_in)
            S[name + ".patch_reduce.weight"] = P[name + ".patch_reduce.weight"][:c_out, :c_in]
            take(name + ".patch_reduce.bias", c_out)
            S[name + ".pos_embed"] = P[name + ".pos_embed"][..., :c_out]
            take(name + ".token_transform.weight", c_out, c_in)
            take(name + ".token_transform.bias", c_out)
            e = c_out
    take("norm.weight", e)
    take("norm.bias", e)
    take("cls_head.weight", None, e)
    S["cls_head.bias"] = P["cls_head.bias"]
    return S


def block_rates(network_def: Sequence, drop_path_rate: float) -> List[float]:
    """Each existing block's stochastic-depth rate: linear from 0 to
    ``drop_path_rate`` over the depth."""
    depth = sum(1 for blk in network_def if blk[0] == TRANSFORMER and blk[3])
    return np.linspace(0.0, drop_path_rate, depth).tolist() if depth else []


def drop_path_draws(network_def: Sequence, drop_path_rate: float) -> List[float]:
    """The rate of each stochastic-depth draw of one forward, in call order."""
    return [r for r in block_rates(network_def, drop_path_rate) if r > 0.0 for _ in range(2)]
