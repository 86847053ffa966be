"""Batch norm over NCHW with flax's rule, and the ReLU after it fused.

The conv stem's norm (``models/patch_embed.py``: ``BatchNorm``, and
``ConvBnAct`` with the ReLU) and the KD teacher's (``models/regnet.py``).
Flax's rule: train-mode statistics in float32 over every process's batch,
``mean = sum(x) / n`` and the biased ``var = max(sum(x^2) / n - mean^2, 0)``,
eps 1e-5, the running statistics moved by momentum 0.9; eval mode
normalizes by the running statistics. Then ``y = (x - mean) * rsqrt(var +
eps) * w + b`` in ``x.dtype``, and ``relu(y)`` where ``relu``.

- A CPU tensor runs :func:`batch_norm_plain` (float32 PyTorch ops under
  autograd; the train-mode sums go through ``parallel.sum_over_processes``).
- A CUDA tensor runs the kernels of ``csrc/batch_norm.cu`` as one autograd
  function, or the call raises: B1's statistics (train mode: a pass, then a
  fold that finishes them and moves the running statistics), B1's normalize
  (one pass, the whole norm in eval mode), and B2 in the backward (the sums
  ``db = sum g``, ``dw = sum g * xh`` with ``g`` the gradient through the
  ReLU's mask, recomputed from x; then dx). It saves x and the per-channel
  statistics, and no float32 copy of x. In a process group the statistics'
  and, in train mode, the backward's per-channel sums are all-reduced between
  the passes, as the plain version's autograd does; ``dw`` and ``db`` stay
  this process's.

x is 4-D, NCHW-contiguous or channels-last, bfloat16 or float32; w, b and the
statistics are float32. Each of the three records counts once per call of its
part (the statistics and B2 with their folds).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import parallel
from . import kernels
from .kernels import Kernel

SOURCE = "vit_search_torch/csrc/batch_norm.cu"
XLA = "none: XLA fuses flax's nn.BatchNorm (vit_search_tpu/models/patch_embed.py:62)"
BN_STATS = kernels.register(Kernel("batch_norm_stats", SOURCE, XLA))
BN_APPLY = kernels.register(Kernel("batch_norm_apply", SOURCE, XLA))
BN_BWD = kernels.register(Kernel("batch_norm_bwd", SOURCE, XLA))

# blocks per SM a reduction pass may take at most: the size of its partials
MAX_PARTS_PER_SM = 4


def batch_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, training: bool,
                     momentum: float, eps: float, relu: bool) -> torch.Tensor:
    """The function in float32 PyTorch ops; moves the running statistics in
    train mode."""
    xf = x.float()
    if training:
        sums = parallel.sum_over_processes(torch.stack(
            [xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
        n = xf.numel() // xf.shape[1] * parallel.process_count()
        mean = sums[0] / n
        var = (sums[1] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean.detach(), alpha=1.0 - momentum)
            running_var.mul_(momentum).add_(var.detach(), alpha=1.0 - momentum)
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    y = y.to(x.dtype)
    return F.relu(y) if relu else y


def _lib():
    lib = kernels.library("batch_norm")
    if not getattr(lib, "_vst_typed", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.vst_bn_stats.argtypes = [p, ll, i, ll, i, p, i, p, p, i, f, f, f, p, p, i, p]
        lib.vst_bn_finalize.argtypes = [p, i, p, p, f, f, f, p, p, p]
        lib.vst_bn_apply.argtypes = [p, p, ll, i, ll, i, p, p, p, p, f, i, i, p]
        lib.vst_bn_bwd_sums.argtypes = [p, p, ll, i, ll, i, p, p, p, p, f, i, p, i, p, p, i, p]
        lib.vst_bn_bwd_dx.argtypes = [p, p, p, ll, i, ll, i, p, p, p, p, f, i, p, p, f, i, p]
        for fn in (lib.vst_bn_stats, lib.vst_bn_finalize, lib.vst_bn_apply,
                   lib.vst_bn_bwd_sums, lib.vst_bn_bwd_dx):
            fn.restype = i
        lib._vst_typed = True
    return lib


def kernel_view(x: torch.Tensor) -> Tuple[int, int, int]:
    """``(outer, C, inner)`` of a 4-D ``x`` as the kernels read it in place:
    ``(B, C, H*W)`` for NCHW-contiguous, ``(B*H*W, C, 1)`` for channels-last;
    raises on any other layout."""
    if x.ndim != 4:
        raise ValueError(f"batch norm needs a 4-D (B, C, H, W) tensor, got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if x.is_contiguous():
        return b, c, h * w
    if x.is_contiguous(memory_format=torch.channels_last):
        return b * h * w, c, 1
    raise ValueError(f"batch norm needs NCHW-contiguous or channels-last x, got strides "
                     f"{x.stride()} for shape {tuple(x.shape)}")


def _as_layout_of(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` (x's shape) stored as x is; no copy where it already is."""
    if x.is_contiguous():
        return t.contiguous()
    return t.contiguous(memory_format=torch.channels_last)


def _check(x: torch.Tensor, channels: Dict[str, torch.Tensor]) -> Tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not in {tuple(kernels.DTYPE_CODES)}")
    if x.numel() == 0:
        raise ValueError(f"batch norm needs a non-empty x, got {tuple(x.shape)}")
    outer, c, inner = kernel_view(x)
    for name, t in channels.items():
        kernels.check_cuda_tensor(t, name, dtypes=(torch.float32,), ndim=1, align=4)
        if t.shape[0] != c:
            raise ValueError(f"{name} has {t.shape[0]} channels, x {c}")
    return outer, c, inner


def _parts(x: torch.Tensor, c: int) -> Tuple[torch.Tensor, int]:
    max_parts = MAX_PARTS_PER_SM * kernels.num_sms(x)
    return torch.empty(max_parts * 2 * c, dtype=torch.float32, device=x.device), max_parts


def batch_stats_cuda(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                     momentum: float) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """B1's statistics: ``(mean, var, n)`` over every process's batch, float32;
    the running statistics move by ``momentum``."""
    outer, c, inner = _check(x, {"running_mean": running_mean, "running_var": running_var})
    n = outer * inner * parallel.process_count()
    parts, max_parts = _parts(x, c)
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    grouped = dist.is_available() and dist.is_initialized()
    running = (running_mean.data_ptr(), running_var.data_ptr())
    lib, stream, sms = _lib(), kernels.stream_ptr(x), kernels.num_sms(x)
    rc = lib.vst_bn_stats(x.data_ptr(), outer, c, inner, kernels.DTYPE_CODES[x.dtype],
                          parts.data_ptr(), max_parts, out[0].data_ptr(), out[1].data_ptr(),
                          0 if grouped else 1, float(n), momentum, 1.0 - momentum, *running,
                          sms, stream)
    kernels.check_launch(rc, "batch norm statistics (B1)")
    if grouped:
        sums = parallel.sum_over_processes(out)
        out = torch.empty_like(sums)
        rc = lib.vst_bn_finalize(sums.data_ptr(), c, out[0].data_ptr(), out[1].data_ptr(),
                                 float(n), momentum, 1.0 - momentum, *running, stream)
        kernels.check_launch(rc, "batch norm statistics (B1, after the all-reduce)")
    BN_STATS.launches += 1
    return out[0], out[1], n


def batch_norm_apply_cuda(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, eps: float,
                          relu: bool) -> torch.Tensor:
    """B1's normalize: ``(x - mean) * rsqrt(var + eps) * w + b``, then the
    ReLU where ``relu``, in x's dtype and layout."""
    outer, c, inner = _check(x, {"mean": mean, "var": var, "weight": weight, "bias": bias})
    y = torch.empty_like(x)
    rc = _lib().vst_bn_apply(x.data_ptr(), y.data_ptr(), outer, c, inner,
                             kernels.DTYPE_CODES[x.dtype], mean.data_ptr(), var.data_ptr(),
                             weight.data_ptr(), bias.data_ptr(), eps, int(relu),
                             kernels.num_sms(x), kernels.stream_ptr(x))
    kernels.check_launch(rc, "batch norm (B1)")
    BN_APPLY.launches += 1
    return y


def batch_norm_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                        var: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                        relu: bool, inv_n: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2: ``(dx, dw, db)``. ``inv_n`` is 1 / n of the statistics (0 where
    they are the running ones); dw and db are this process's sums, dx uses
    every process's (all-reduced only where ``inv_n``: the running statistics
    do not depend on x)."""
    outer, c, inner = _check(x, {"mean": mean, "var": var, "weight": weight, "bias": bias})
    dy = _as_layout_of(dy, x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    parts, max_parts = _parts(x, c)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    lib, stream, sms = _lib(), kernels.stream_ptr(x), kernels.num_sms(x)
    dtype = kernels.DTYPE_CODES[x.dtype]
    args = (mean.data_ptr(), var.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps, int(relu))
    rc = lib.vst_bn_bwd_sums(x.data_ptr(), dy.data_ptr(), outer, c, inner, dtype, *args,
                             parts.data_ptr(), max_parts, sums[0].data_ptr(),
                             sums[1].data_ptr(), sms, stream)
    kernels.check_launch(rc, "batch norm backward sums (B2)")
    every = parallel.sum_over_processes(sums) if inv_n else sums
    dx = torch.empty_like(x)
    rc = lib.vst_bn_bwd_dx(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), outer, c, inner, dtype,
                           *args, every[0].data_ptr(), every[1].data_ptr(), inv_n, sms, stream)
    kernels.check_launch(rc, "batch norm backward (B2)")
    BN_BWD.launches += 1
    return dx, sums[1], sums[0]


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, training, momentum, eps,
                relu):
        if training:
            mean, var, n = batch_stats_cuda(x, running_mean, running_var, momentum)
            ctx.inv_n = 1.0 / n
        else:
            # copies: a later train-mode forward moves the running statistics
            # in place, unseen by autograd
            mean, var = running_mean.clone(), running_var.clone()
            ctx.inv_n = 0.0
        ctx.eps, ctx.relu = eps, relu
        ctx.save_for_backward(x, weight, bias, mean, var)
        return batch_norm_apply_cuda(x, mean, var, weight, bias, eps, relu)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, var = ctx.saved_tensors
        dx, dw, db = batch_norm_bwd_cuda(x, dy, mean, var, weight, bias, ctx.eps, ctx.relu,
                                         ctx.inv_n)
        return dx, dw, db, None, None, None, None, None, None


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, training: bool,
               momentum: float, eps: float, relu: bool) -> torch.Tensor:
    """Batch norm of a 4-D ``x`` (flax's rule), then the ReLU where ``relu``;
    train mode moves the running statistics in place."""
    if x.device.type == "cpu":
        return batch_norm_plain(x, weight, bias, running_mean, running_var, training,
                                momentum, eps, relu)
    return _BatchNorm.apply(x, weight, bias, running_mean, running_var, training, momentum,
                            eps, relu)
