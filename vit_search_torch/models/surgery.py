"""Parameter surgery on the port's state dicts: subnet extraction, rewiring,
position-embedding interpolation.

Port of vit_search_tpu/models/surgery.py, on state dicts keyed by the
reference torch names (``blocks.<j>`` counts bypass slots too):

- :func:`slice_subnet_params` fills a sub-architecture's state dict with
  prefix slices of the supernet's (every axis; the fused qkv projection per
  q/k/v third). Valid because channel masks keep a prefix and rewiring keeps
  the important channels at the front.
- :func:`rewire_params` sorts every existing block's MLP hidden units and
  attention heads by weight magnitude, most important first.
- :func:`interpolate_pos_embeds` resizes every position-embedding table
  whose length differs, for a finetune at a higher resolution. The top-level
  ``pos_embed`` keeps its ``num_tokens`` token rows; SR-block tables
  (``blocks.<j>.pos_embed``) are all grid.

The resize is the JAX package's ``jax.image.resize(..., "bicubic")``: Keys'
cubic kernel with a = -0.5, half-pixel centres, the kernel widened to
antialias when a grid shrinks, applied as two float32 weight matrices.
``F.interpolate(mode="bicubic")`` is another function (a = -0.75, no
antialiasing) and is not used.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..arch import network_def as nd

StateDict = Dict[str, torch.Tensor]


# --- subnet extraction -----------------------------------------------------


def _prefix_slice(src: torch.Tensor, shape) -> torch.Tensor:
    if src.ndim != len(shape):
        raise ValueError(f"rank mismatch: {tuple(src.shape)} -> {tuple(shape)}")
    return src[tuple(slice(0, d) for d in shape)]


def _slice_qkv(src: torch.Tensor, shape) -> torch.Tensor:
    """Prefix-slice each q/k/v third of the fused output axis (axis 0 of a
    ``(3W, C)`` weight or a ``(3W,)`` bias), then every other axis."""
    src_w, dst_w = src.shape[0] // 3, shape[0] // 3
    merged = torch.cat([src[i * src_w:i * src_w + dst_w] for i in range(3)])
    return _prefix_slice(merged, shape)


def slice_subnet_params(super_sd: Mapping[str, torch.Tensor],
                        sub_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """``sub_sd``-shaped entries cut from ``super_sd`` (same keys), in
    ``sub_sd``'s dtypes. Every key of the subnet must be in the supernet."""
    out = {}
    for key, leaf in sub_sd.items():
        if key not in super_sd:
            raise KeyError(f"subnet entry {key} missing in supernet")
        src = super_sd[key]
        sliced = (_slice_qkv(src, leaf.shape) if ".qkv." in key
                  else _prefix_slice(src, leaf.shape))
        out[key] = sliced.to(leaf.dtype).clone()
    return out


# --- rewiring -----------------------------------------------------------------


def _descending(importance: torch.Tensor) -> torch.Tensor:
    return torch.argsort(-importance, stable=True)


def rewire_mlp(sd: StateDict, prefix: str) -> None:
    """Sort one block's MLP hidden units by sum|fc2 in-columns| + sum|fc1
    rows| + |fc1 bias| (reference nets/supernet_blocks.py:55-71), in place."""
    fc1_w, fc1_b = sd[f"{prefix}.fc1.weight"], sd[f"{prefix}.fc1.bias"]   # (H, in), (H,)
    fc2_w = sd[f"{prefix}.fc2.weight"]                                     # (out, H)
    order = _descending(fc2_w.abs().sum(0) + fc1_w.abs().sum(1) + fc1_b.abs())
    sd[f"{prefix}.fc1.weight"] = fc1_w[order]
    sd[f"{prefix}.fc1.bias"] = fc1_b[order]
    sd[f"{prefix}.fc2.weight"] = fc2_w[:, order]


def rewire_attention(sd: StateDict, prefix: str, num_heads: int, head_dim: int) -> None:
    """Sort one block's heads by sum|qkv weights| + sum|qkv bias| + sum|proj
    in-columns| (reference nets/supernet_blocks.py:123-161), the same order
    in each q/k/v third and in the projection's input, in place."""
    qkv_w, qkv_b = sd[f"{prefix}.qkv.weight"], sd[f"{prefix}.qkv.bias"]   # (3Hd, C), (3Hd,)
    proj_w = sd[f"{prefix}.proj.weight"]                                   # (out, Hd)
    c_in, c_out = qkv_w.shape[1], proj_w.shape[0]
    w_heads = qkv_w.reshape(3, num_heads, head_dim, c_in)
    b_heads = qkv_b.reshape(3, num_heads, head_dim)
    p_heads = proj_w.reshape(c_out, num_heads, head_dim)
    order = _descending(w_heads.abs().sum((0, 2, 3)) + b_heads.abs().sum((0, 2))
                        + p_heads.abs().sum((0, 2)))
    sd[f"{prefix}.qkv.weight"] = w_heads[:, order].reshape(qkv_w.shape)
    sd[f"{prefix}.qkv.bias"] = b_heads[:, order].reshape(qkv_b.shape)
    sd[f"{prefix}.proj.weight"] = p_heads[:, order].reshape(proj_w.shape)


def rewire_params(sd: Mapping[str, torch.Tensor], network_def: Sequence) -> StateDict:
    """A copy of ``sd`` with every existing transformer block rewired."""
    out = dict(sd)
    for slot, block in enumerate(network_def):
        if nd.block_type(block) != nd.TRANSFORMER:
            continue
        tdef = nd.transformer_def(block)
        if tdef.exists:
            rewire_attention(out, f"blocks.{slot - 1}.attn", tdef.num_heads, tdef.head_dim)
            rewire_mlp(out, f"blocks.{slot - 1}.mlp")
    return out


# --- position-embedding interpolation -----------------------------------------


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (``jax.image``'s), on ``|x|``."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def resize_weights(src: int, dst: int) -> np.ndarray:
    """``(src, dst)`` float32 weights of a bicubic resize along one axis, as
    ``jax.image.resize`` computes them (``compute_weight_mat``): half-pixel
    sample positions, the kernel widened by ``src / dst`` when shrinking
    (antialiasing), each column normalised to sum to one."""
    inv_scale = 1.0 / (dst / src)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(dst, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale)
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(src, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_grid(grid: torch.Tensor, dst: int) -> torch.Tensor:
    """Bicubic resize of a ``(G, G, C)`` float32 grid to ``(dst, dst, C)``,
    separable, on ``grid``'s device. The products are summed elementwise in
    float32, so no TF32 matmul setting changes the result."""
    w = torch.as_tensor(resize_weights(grid.shape[0], dst), device=grid.device)
    rows = (w[:, :, None, None] * grid[:, None]).sum(0)            # (dst, G, C)
    return (w[None, :, :, None] * rows[:, :, None]).sum(1)          # (dst, dst, C)


def _resize_table(table: torch.Tensor, num_tokens: int, dst_len: int) -> torch.Tensor:
    """Resize the grid part of a ``(1, T + G*G, C)`` table to ``dst_len`` rows;
    the ``T`` token rows are copied as they are."""
    if table.shape[1] == dst_len:
        return table
    tokens, grid = table[:, :num_tokens], table[:, num_tokens:]
    src_g, dst_g = math.isqrt(grid.shape[1]), math.isqrt(dst_len - num_tokens)
    if src_g * src_g != grid.shape[1] or dst_g * dst_g != dst_len - num_tokens:
        raise ValueError(f"non-square grid: {grid.shape[1]} -> {dst_len - num_tokens} rows")
    c = grid.shape[-1]
    resized = resize_grid(grid.reshape(src_g, src_g, c).float(), dst_g)
    return torch.cat([tokens, resized.reshape(1, dst_g * dst_g, c).to(table.dtype)], dim=1)


_SR_TABLE = re.compile(r"blocks\.\d+\.pos_embed")


def interpolate_pos_embeds(src_sd: Mapping[str, torch.Tensor],
                           dst_sd: Mapping[str, torch.Tensor],
                           num_tokens: int) -> StateDict:
    """``src_sd``'s entries in ``dst_sd``'s shapes, dtypes and device, each
    position-embedding table of another length resized on ``src_sd``'s
    device (reference network_utils/finetune_state_dict.py:24-66). Every
    other entry must have the same shape on both sides."""
    out = {}
    for key, leaf in dst_sd.items():
        if key not in src_sd:
            raise KeyError(f"target entry {key} missing in source")
        src = src_sd[key]
        if src.shape != leaf.shape and (key == "pos_embed" or _SR_TABLE.fullmatch(key)):
            src = _resize_table(src, num_tokens if key == "pos_embed" else 0, leaf.shape[1])
        elif src.shape != leaf.shape:
            raise ValueError(f"shape mismatch at {key}: {tuple(src.shape)} vs "
                             f"{tuple(leaf.shape)}")
        out[key] = src.to(device=leaf.device, dtype=leaf.dtype, copy=True)
    return out
