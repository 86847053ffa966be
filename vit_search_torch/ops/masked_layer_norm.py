"""Masked layer normalization.

Layer norm whose statistics are corrected for masked-out (zeroed) trailing
channels: with ``p`` the fraction of unmasked channels, the plain channel
means of ``x`` and ``x**2`` are rescaled by ``1/p``. Statistics are float32
whatever the input dtype; the output is re-masked.

    inv_p = 1 / mean_C(mask);  mu = mean_C(x) * inv_p
    var = mean_C(x^2) * inv_p - mu^2
    y = (weight * (x - mu) * rsqrt(var + eps) + bias) * mask

Port of vit_search_tpu/ops/masked_layer_norm.py and its Pallas kernels
(ops/pallas/masked_ln.py, ops/pallas/stats.py).

The dense path (``mask is None``): the JAX package leaves it to XLA, which
fuses it. Here a CUDA tensor goes through K3 and K4 in their dense mode (a
null mask: ``m = 1``, ``inv_p = 1``, the variance from two passes over the
row, ``mean((x - mu)^2)``), as one autograd function that saves ``x`` and
float32 ``(mu, inv_std)`` per row; their launches count on their own
records, ``LN_FWD`` and ``LN_BWD``. A CPU tensor runs
:func:`layer_norm_plain`. The masked path takes one of two routes:

- ``"fused"`` (the JAX package's ``VST_PALLAS_LN=1``): one autograd function
  whose forward saves float32 ``(mu, inv_std)`` per row; K3
  (``csrc/masked_ln.cu``, forward) and K4 (backward) for CUDA tensors,
  :func:`masked_ln_fwd_plain` and :func:`masked_ln_bwd_plain` for CPU tensors;
- ``"stats"`` (``VST_PALLAS_LN_STATS=1``): K5 (``ops/stats.py``) gives the
  row sums of ``x`` and ``x**2`` from one read, and the normalize, affine and
  mask arithmetic is plain PyTorch, in the operation order of
  masked_layer_norm.py:84-92; autograd differentiates it.

A CUDA tensor goes through the kernels, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from . import kernels
from .kernels import Kernel
from .stats import row_sum_sumsq

K3 = kernels.register(Kernel(
    "masked_layer_norm_fwd", "vit_search_torch/csrc/masked_ln.cu",
    "vit_search_tpu/ops/pallas/masked_ln.py:40"))
K4 = kernels.register(Kernel(
    "masked_layer_norm_bwd", "vit_search_torch/csrc/masked_ln.cu",
    "vit_search_tpu/ops/pallas/masked_ln.py:58"))
# K3 and K4 in their dense mode, for the layer norms of a net without masks
LN_FWD = kernels.register(Kernel(
    "layer_norm_fwd", "vit_search_torch/csrc/masked_ln.cu",
    "vit_search_tpu/ops/masked_layer_norm.py:62"))
LN_BWD = kernels.register(Kernel(
    "layer_norm_bwd", "vit_search_torch/csrc/masked_ln.cu",
    "vit_search_tpu/ops/masked_layer_norm.py:62"))

MAX_KERNEL_CHANNELS = 2048
ROUTES = ("fused", "stats")


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The dense layer norm (masked_layer_norm.py:62-66) in float32, in
    ``x.dtype``; autograd differentiates it."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (weight.float() * y + bias.float()).to(x.dtype)


def masked_ln_fwd_plain(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function: ``(y, stats)`` with ``stats[..., 0] = mu`` and
    ``stats[..., 1] = inv_std`` in float32."""
    xf, m = x.float(), mask.float()
    inv_p = 1.0 / m.mean(-1, keepdim=True)
    mu = xf.mean(-1, keepdim=True) * inv_p
    var = (xf * xf).mean(-1, keepdim=True) * inv_p - mu * mu
    inv_std = torch.rsqrt(var + eps)
    y = (weight.float() * ((xf - mu) * inv_std) + bias.float()) * m
    return y.to(x.dtype), torch.cat([mu, inv_std], dim=-1)


def masked_ln_bwd_plain(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                        stats: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's function: ``(gx, gw, gb)``; gw/gb summed over every row."""
    xf, m = x.float(), mask.float()
    mu, inv_std = stats[..., :1], stats[..., 1:]
    inv_p = 1.0 / m.mean(-1, keepdim=True)
    z = (xf - mu) * inv_std
    gf = g.float() * m
    dz = gf * weight.float()
    gx = (dz - (dz.mean(-1, keepdim=True) + z * (z * dz).mean(-1, keepdim=True)) * inv_p) * inv_std
    rows = tuple(range(x.ndim - 1))
    return gx.to(g.dtype), (gf * z).sum(rows), gf.sum(rows)


# The launch plan of K3 and K4 (csrc/masked_ln.cu). A tile is at most
# TILE_BYTES of x (at most MAX_TILE_ROWS rows, a multiple of the block's 8
# warps where it holds 8 or more); the ring holds RING_STAGES tiles where the
# blocks per SM the kernels are compiled for still fit in the SM's shared
# memory, else fewer; the persistent grid is that many blocks per SM, or one
# per tile. Two stages measured faster than three for K4 on the H100.
TILE_BYTES = 16384
MAX_TILE_ROWS = 256
RING_STAGES = {False: 3, True: 2}        # K3, K4
BLOCKS_PER_SM = {False: 4, True: 2}      # K3, K4 (their __launch_bounds__)
MAX_BLOCK_SMEM = 232448                  # dynamic shared bytes a block may opt into
SM_SMEM = 233472                         # shared bytes of an SM; a block also holds 1 KB
BLOCK_THREADS = 256


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How K3 or K4 is launched. ``tile_rows == 0`` is the general path (a
    warp per row): for a bf16 row that is not whole 16-byte vectors, or an
    input not on a 16-byte boundary. ``grid`` is the blocks of the first
    launch, and K4's count of (2, C) partials."""

    tile_rows: int
    grid: int
    stages: int
    mask_rows: int
    smem_bytes: int


def _round128(v: int) -> int:
    return -(-v // 128) * 128


def tiled_smem_bytes(backward: bool, c: int, itemsize: int, tile_rows: int, stages: int,
                     mask_rows: int) -> int:
    """Shared bytes of a tiled block: ``tiled_smem_bytes`` of csrc/masked_ln.cu,
    which refuses a launch that disagrees."""
    row = c * itemsize
    ring = stages * ((2 if backward else 1) * tile_rows + mask_rows) * row
    if backward:
        nchunks = c // (16 // itemsize)
        phases = 1 if nchunks >= BLOCK_THREADS else BLOCK_THREADS // nchunks
        ring = max(ring, phases * 2 * c * 4)
    return (256 + _round128((1 if backward else 2) * c * 4) + _round128(mask_rows * 4)
            + (_round128(tile_rows * 8) if backward else 0) + _round128(tile_rows * 4) + ring)


def launch_plan(rows: int, n: int, c: int, itemsize: int, shared_mask: bool, aligned: bool,
                sms: int, backward: bool, dense: bool = False) -> LaunchPlan:
    """The launch of K3 (K4 where ``backward``) over ``rows`` rows of ``c``
    channels, ``n`` rows per example; ``aligned``: x, g and the mask start on
    16-byte boundaries. ``dense``: no mask, so no mask rows staged."""
    if not aligned or (c * itemsize) % 16:
        groups = -(-rows // 8)
        if backward:
            return LaunchPlan(0, max(1, min(groups, 4 * sms)), 0, 0, 2 * c * 4)
        return LaunchPlan(0, groups, 0, 0, 0)
    tile_rows = max(1, min(MAX_TILE_ROWS, TILE_BYTES // (c * itemsize), rows))
    if tile_rows >= 8:
        tile_rows -= tile_rows % 8
    if dense:
        mask_rows = 0
    else:
        mask_rows = 1 if shared_mask else min(tile_rows, (tile_rows - 1) // n + 2)
    per_sm = BLOCKS_PER_SM[backward]
    for stages in range(RING_STAGES[backward], 1, -1):
        smem = tiled_smem_bytes(backward, c, itemsize, tile_rows, stages, mask_rows)
        if per_sm * (smem + 1024) <= SM_SMEM:
            break
    per_sm = max(1, min(per_sm, SM_SMEM // (smem + 1024)))
    tiles = -(-rows // tile_rows)
    return LaunchPlan(tile_rows, min(tiles, sms * per_sm), stages, mask_rows, smem)


def _lib():
    lib = kernels.library("masked_ln")
    if not getattr(lib, "_vst_typed", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.vst_masked_ln_fwd.argtypes = [p, p, ll, p, p, p, p, ll, i, i, f, i, i, i, i, i,
                                          ll, p]
        lib.vst_masked_ln_fwd.restype = i
        lib.vst_masked_ln_bwd.argtypes = [p, p, ll, p, p, p, p, p, i, p, p, ll, i, i, i, i,
                                          i, i, ll, p]
        lib.vst_masked_ln_bwd.restype = i
        lib._vst_typed = True
    return lib


def _check_x(x: torch.Tensor) -> None:
    """The general path loads 4 elements at a time, so x must start on a
    4-element boundary."""
    kernels.check_cuda_tensor(x, "x", ndim=3, align=4 * x.element_size())
    c = x.shape[2]
    if c % 4 or c > MAX_KERNEL_CHANNELS:
        raise ValueError(f"masked-LN kernel takes C % 4 == 0 and C <= "
                         f"{MAX_KERNEL_CHANNELS}, got C={c}")


def _check(x: torch.Tensor, mask: torch.Tensor) -> int:
    """Validate a masked kernel call; returns the mask's batch stride (0 =
    shared). The mask, too, must start on a 4-element boundary."""
    _check_x(x)
    kernels.check_cuda_tensor(mask, "mask", dtypes=(x.dtype,), ndim=3,
                              align=4 * x.element_size())
    b, _, c = x.shape
    if mask.shape[1] != 1 or mask.shape[2] != c or mask.shape[0] not in (1, b):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not fit x {tuple(x.shape)}")
    return 0 if mask.shape[0] == 1 else c


def _params(t: torch.Tensor, c: int, name: str) -> torch.Tensor:
    t = t.float().contiguous()
    if t.shape != (c,):
        raise ValueError(f"{name} shape {tuple(t.shape)} != ({c},)")
    kernels.check_cuda_tensor(t, name, dtypes=(torch.float32,), ndim=1)
    return t


def _plan(x: torch.Tensor, mask: Optional[torch.Tensor], backward: bool, *more: torch.Tensor
          ) -> LaunchPlan:
    b, n, c = x.shape
    ins = (x, *more) if mask is None else (x, mask, *more)
    aligned = all(t.data_ptr() % 16 == 0 for t in ins)
    return launch_plan(b * n, n, c, x.element_size(), mask is not None and mask.shape[0] == 1,
                       aligned, kernels.num_sms(x), backward, dense=mask is None)


def _fwd(x: torch.Tensor, mask: Optional[torch.Tensor], bstride: int, weight: torch.Tensor,
         bias: torch.Tensor, eps: float, what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's launch; a ``None`` mask is its dense mode."""
    b, n, c = x.shape
    w, bb = _params(weight, c, "weight"), _params(bias, c, "bias")
    plan = _plan(x, mask, False)
    y = torch.empty_like(x)
    stats = torch.empty((b, n, 2), dtype=torch.float32, device=x.device)
    rc = _lib().vst_masked_ln_fwd(x.data_ptr(), None if mask is None else mask.data_ptr(),
                                  bstride, w.data_ptr(), bb.data_ptr(), y.data_ptr(),
                                  stats.data_ptr(), b * n, n, c, eps,
                                  kernels.DTYPE_CODES[x.dtype], plan.tile_rows, plan.grid,
                                  plan.stages, plan.mask_rows, plan.smem_bytes,
                                  kernels.stream_ptr(x))
    kernels.check_launch(rc, what)
    return y, stats


def _bwd(x: torch.Tensor, mask: Optional[torch.Tensor], bstride: int, weight: torch.Tensor,
         stats: torch.Tensor, g: torch.Tensor, what: str
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's two launches; a ``None`` mask is its dense mode."""
    b, n, c = x.shape
    kernels.check_cuda_tensor(g, "g", dtypes=(x.dtype,), ndim=3, align=4 * x.element_size())
    kernels.check_cuda_tensor(stats, "stats", dtypes=(torch.float32,), ndim=3, align=8)
    if g.shape != x.shape or stats.shape != (b, n, 2):
        raise ValueError("g must match x and stats must be (B, N, 2)")
    w = _params(weight, c, "weight")
    plan = _plan(x, mask, True, g)
    gx = torch.empty_like(x)
    partial = torch.empty((plan.grid, 2, c), dtype=torch.float32, device=x.device)
    gw = torch.empty((c,), dtype=torch.float32, device=x.device)
    gb = torch.empty((c,), dtype=torch.float32, device=x.device)
    rc = _lib().vst_masked_ln_bwd(x.data_ptr(), None if mask is None else mask.data_ptr(),
                                  bstride, w.data_ptr(), stats.data_ptr(), g.data_ptr(),
                                  gx.data_ptr(), partial.data_ptr(), plan.grid, gw.data_ptr(),
                                  gb.data_ptr(), b * n, n, c, kernels.DTYPE_CODES[x.dtype],
                                  plan.tile_rows, plan.stages, plan.mask_rows,
                                  plan.smem_bytes, kernels.stream_ptr(x))
    kernels.check_launch(rc, what)
    return gx, gw, gb


def masked_ln_fwd_cuda(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3."""
    bstride = _check(x, mask)
    out = _fwd(x, mask, bstride, weight, bias, eps, "masked layer norm forward (K3)")
    K3.launches += 1
    return out


def masked_ln_bwd_cuda(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                       stats: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K4: gx and a (2, C) partial of gw, gb per block, then the
    partials' fold in a fixed order."""
    bstride = _check(x, mask)
    out = _bwd(x, mask, bstride, weight, stats, g, "masked layer norm backward (K4)")
    K4.launches += 1
    return out


def layer_norm_fwd_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 in its dense mode: ``(y, stats)``, ``stats[..., 0] = mu``,
    ``stats[..., 1] = inv_std`` in float32."""
    _check_x(x)
    out = _fwd(x, None, 0, weight, bias, eps, "layer norm forward (K3, dense)")
    LN_FWD.launches += 1
    return out


def layer_norm_bwd_cuda(x: torch.Tensor, weight: torch.Tensor, stats: torch.Tensor,
                        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K4 in its dense mode: ``(gx, gw, gb)``, gw and gb float32."""
    _check_x(x)
    out = _bwd(x, None, 0, weight, stats, g, "layer norm backward (K4, dense)")
    LN_BWD.launches += 1
    return out


class _MaskedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mask, eps):
        if x.device.type == "cpu":
            y, stats = masked_ln_fwd_plain(x, mask, weight, bias, eps)
        else:
            y, stats = masked_ln_fwd_cuda(x, mask, weight, bias, eps)
        ctx.save_for_backward(x, mask, weight, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mask, weight, stats = ctx.saved_tensors
        g = g.contiguous()
        if x.device.type == "cpu":
            gx, gw, gb = masked_ln_bwd_plain(x, mask, weight, stats, g)
        else:
            gx, gw, gb = masked_ln_bwd_cuda(x, mask, weight, stats, g)
        return gx, gw.to(weight.dtype), gb.to(weight.dtype), None, None


class _LayerNorm(torch.autograd.Function):
    """The dense layer norm on K3/K4's dense mode: saves x and the float32
    ``(mu, inv_std)`` of each row."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, stats = layer_norm_fwd_cuda(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, stats = ctx.saved_tensors
        gx, gw, gb = layer_norm_bwd_cuda(x, weight, stats, g.contiguous())
        return gx, gw.to(weight.dtype), gb.to(weight.dtype), None


def _stats_route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mask: torch.Tensor, eps: float) -> torch.Tensor:
    """The masked path from K5's row sums (masked_layer_norm.py:78-92)."""
    xf, maskf = x.float(), mask.float()
    inv_p = 1.0 / maskf.mean(-1, keepdim=True)
    s1, s2 = row_sum_sumsq(x)
    scale = inv_p * (1.0 / x.shape[-1])
    mu = s1.unsqueeze(-1) * scale
    var = s2.unsqueeze(-1) * scale - mu.square()
    z = (xf - mu) / torch.sqrt(var + eps)
    y = weight.float() * z + bias.float()
    return (y * maskf).to(x.dtype)


def masked_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      mask: Optional[torch.Tensor], eps: float = 1e-6,
                      route: str = "fused") -> torch.Tensor:
    """Masked layer norm over the last axis.

    ``x`` is ``(..., N, C)`` with masked channels already zeroed; ``mask`` is
    ``(B or 1, 1, C)`` (boolean or 0/1), or ``None`` for dense layer norm
    (on K3/K4's dense mode for a CUDA tensor).
    ``route`` picks how the masked path runs (``"fused"`` or ``"stats"``, see
    the module docstring). Returns ``x.dtype``.
    """
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if mask is None:
        if x.is_cuda:
            return _LayerNorm.apply(x.contiguous(), weight, bias, float(eps))
        return layer_norm_plain(x, weight, bias, eps)
    if route == "stats":
        return _stats_route(x, weight, bias, mask, eps)
    return _MaskedLayerNorm.apply(x.contiguous(), weight, bias,
                                  mask.to(x.dtype).contiguous(), float(eps))
