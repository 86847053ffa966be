"""Masked layer normalization.

Layer norm whose statistics are corrected for masked-out (zeroed) trailing
channels: with ``p`` the fraction of unmasked channels, the plain channel
means of ``x`` and ``x**2`` are rescaled by ``1/p``. Statistics are float32
whatever the input dtype; the output is re-masked.

    inv_p = 1 / mean_C(mask);  mu = mean_C(x) * inv_p
    var = mean_C(x^2) * inv_p - mu^2
    y = (weight * (x - mu) * rsqrt(var + eps) + bias) * mask

Port of vit_search_tpu/ops/masked_layer_norm.py and its Pallas kernels
(ops/pallas/masked_ln.py, ops/pallas/stats.py). The dense path (``mask is
None``) stays plain PyTorch, as the JAX package leaves it to XLA. The masked
path takes one of two routes:

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
import math
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

MAX_KERNEL_CHANNELS = 2048
ROUTES = ("fused", "stats")


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


def _lib():
    lib = kernels.library("masked_ln")
    if not getattr(lib, "_vst_typed", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.vst_masked_ln_fwd.argtypes = [p, p, ll, p, p, p, p, i, i, i, f, i, p]
        lib.vst_masked_ln_fwd.restype = i
        lib.vst_masked_ln_bwd.argtypes = [p, p, ll, p, p, p, p, p, i, p, p, i, i, i, i, p]
        lib.vst_masked_ln_bwd.restype = i
        lib._vst_typed = True
    return lib


def _check(x: torch.Tensor, mask: torch.Tensor) -> int:
    """Validate a kernel call; returns the mask's batch stride (0 = shared)."""
    kernels.check_cuda_tensor(x, "x", ndim=3)
    kernels.check_cuda_tensor(mask, "mask", dtypes=(x.dtype,), ndim=3)
    b, _, c = x.shape
    if c % 4 or c > MAX_KERNEL_CHANNELS:
        raise ValueError(f"masked-LN kernel takes C % 4 == 0 and C <= "
                         f"{MAX_KERNEL_CHANNELS}, got C={c}")
    if mask.shape[1] != 1 or mask.shape[2] != c or mask.shape[0] not in (1, b):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not fit x {tuple(x.shape)}")
    return 0 if mask.shape[0] == 1 else c


def _params(t: torch.Tensor, c: int, name: str) -> torch.Tensor:
    t = t.float().contiguous()
    if t.shape != (c,):
        raise ValueError(f"{name} shape {tuple(t.shape)} != ({c},)")
    kernels.check_cuda_tensor(t, name, dtypes=(torch.float32,), ndim=1)
    return t


def masked_ln_fwd_cuda(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3."""
    bstride = _check(x, mask)
    b, n, c = x.shape
    w, bb = _params(weight, c, "weight"), _params(bias, c, "bias")
    y = torch.empty_like(x)
    stats = torch.empty((b, n, 2), dtype=torch.float32, device=x.device)
    rc = _lib().vst_masked_ln_fwd(x.data_ptr(), mask.data_ptr(), bstride, w.data_ptr(),
                                  bb.data_ptr(), y.data_ptr(), stats.data_ptr(), b * n, n,
                                  c, eps, kernels.DTYPE_CODES[x.dtype],
                                  kernels.stream_ptr(x))
    kernels.check_launch(rc, "masked layer norm forward (K3)")
    K3.launches += 1
    return y, stats


def masked_ln_bwd_cuda(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                       stats: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K4 (per-block partial sums, then their ordered reduction)."""
    bstride = _check(x, mask)
    b, n, c = x.shape
    kernels.check_cuda_tensor(g, "g", dtypes=(x.dtype,), ndim=3)
    kernels.check_cuda_tensor(stats, "stats", dtypes=(torch.float32,), ndim=3)
    if g.shape != x.shape or stats.shape != (b, n, 2):
        raise ValueError("g must match x and stats must be (B, N, 2)")
    w = _params(weight, c, "weight")
    rows = b * n
    nparts = max(1, min(math.ceil(rows / 8), 4 * kernels.num_sms(x)))
    gx = torch.empty_like(x)
    partial = torch.empty((nparts, 2, c), dtype=torch.float32, device=x.device)
    gw = torch.empty((c,), dtype=torch.float32, device=x.device)
    gb = torch.empty((c,), dtype=torch.float32, device=x.device)
    rc = _lib().vst_masked_ln_bwd(x.data_ptr(), mask.data_ptr(), bstride, w.data_ptr(),
                                  stats.data_ptr(), g.data_ptr(), gx.data_ptr(),
                                  partial.data_ptr(), nparts, gw.data_ptr(), gb.data_ptr(),
                                  rows, n, c, kernels.DTYPE_CODES[x.dtype],
                                  kernels.stream_ptr(x))
    kernels.check_launch(rc, "masked layer norm backward (K4)")
    K4.launches += 1
    return gx, gw, gb


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
    ``(B or 1, 1, C)`` (boolean or 0/1), or ``None`` for dense layer norm.
    ``route`` picks how the masked path runs (``"fused"`` or ``"stats"``, see
    the module docstring). Returns ``x.dtype``.
    """
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if mask is None:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + eps)
        return (weight.float() * y + bias.float()).to(x.dtype)
    if route == "stats":
        return _stats_route(x, weight, bias, mask, eps)
    return _MaskedLayerNorm.apply(x.contiguous(), weight, bias,
                                  mask.to(x.dtype).contiguous(), float(eps))
