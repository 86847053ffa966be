"""One-pass row statistics: float32 ``sum_C x`` and ``sum_C x**2``.

Port of ``row_sum_sumsq`` (vit_search_tpu/ops/pallas/stats.py:71-89), the
statistics half of masked layer norm on its ``"stats"`` route: one read of
``x`` gives both sums, and the normalize, affine and mask arithmetic stay in
plain PyTorch around it.

- K5 (``csrc/stats.cu``) computes the pair for CUDA tensors;
- :func:`row_sum_sumsq_plain` computes the same function in plain PyTorch,
  for CPU tensors.

The gradient is elementwise, ``gx = g1 + 2 * x * g2`` in ``x.dtype``
(stats.py:82-86), and stays plain PyTorch on either device. A CUDA tensor
goes through the kernel, or the wrapper raises. The kernel takes any ``C``:
the JAX package's ``C % 128`` rule (stats.py:92-93) is a TPU tiling limit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernels
from .kernels import Kernel

K5 = kernels.register(Kernel(
    "row_sum_sumsq", "vit_search_torch/csrc/stats.cu",
    "vit_search_tpu/ops/pallas/stats.py:39"))

ROWS_PER_BLOCK = 8     # one warp per row, 8 warps per block (stats.cu kWarps)
BLOCKS_PER_SM = 8      # 8 blocks of 256 threads fill an SM's 2048 threads


def row_sum_sumsq_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's function: ``(sum_C(x), sum_C(x**2))`` over the last axis, float32."""
    xf = x.float()
    return xf.sum(-1), (xf * xf).sum(-1)


def _lib():
    lib = kernels.library("stats")
    if not getattr(lib, "_vst_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vst_row_stats.argtypes = [p, p, p, ll, i, i, i, p]
        lib.vst_row_stats.restype = i
        lib._vst_typed = True
    return lib


def row_sum_sumsq_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on a contiguous ``(..., C)`` CUDA tensor (bf16 or f32)."""
    kernels.check_cuda_tensor(x, "x")
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"row statistics need a non-empty (..., C) tensor, got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    rows = x.numel() // c
    s1 = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    blocks = max(1, min(-(-rows // ROWS_PER_BLOCK), BLOCKS_PER_SM * kernels.num_sms(x)))
    rc = _lib().vst_row_stats(x.data_ptr(), s1.data_ptr(), s2.data_ptr(), rows, c, blocks,
                              kernels.DTYPE_CODES[x.dtype], kernels.stream_ptr(x))
    kernels.check_launch(rc, "row statistics (K5)")
    K5.launches += 1
    return s1, s2


class _RowSumSumsq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return row_sum_sumsq_plain(x)
        return row_sum_sumsq_cuda(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        return (g1.unsqueeze(-1) + 2.0 * x.float() * g2.unsqueeze(-1)).to(x.dtype)


def row_sum_sumsq(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum_C(x), sum_C(x**2))`` over the last axis, float32, differentiable."""
    return _RowSumSumsq.apply(x.contiguous())
