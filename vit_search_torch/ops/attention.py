"""Fused multi-head attention over the packed qkv projection.

Port of ``fused_attention_qkv`` (vit_search_tpu/ops/pallas/attention.py:247).
The input is the ``(B, N, 3W)`` projection output with column blocks
``[q | k | v]``, each ordered by head; the output is ``(B, N, W)``. The
backward recomputes the probabilities from ``qkv`` (the only residual) and
returns the packed ``(B, N, 3W)`` cotangent.

Two kernels, both in ``csrc/attention.cu``:

- K1 (forward): scores and softmax in float32, probabilities cast to the
  value dtype before ``p @ v`` (summed in float32);
- K2 (backward): everything in float32 from the recomputed float32 ``p``.

Beside them, :func:`attention_qkv_plain` and :func:`attention_qkv_bwd_plain`
compute the same functions in plain PyTorch. A CPU tensor goes through the
plain versions; a CUDA tensor goes through the kernels, or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .kernels import Kernel

K1 = kernels.register(Kernel(
    "attention_qkv_fwd", "vit_search_torch/csrc/attention.cu",
    "vit_search_tpu/ops/pallas/attention.py:88"))
K2 = kernels.register(Kernel(
    "attention_qkv_bwd", "vit_search_torch/csrc/attention.cu",
    "vit_search_tpu/ops/pallas/attention.py:108"))

KERNEL_HEAD_DIMS = (8, 16, 32, 48, 64, 128)
MAX_SMEM_BYTES = 232448


def supported(n: int, d: int, attn_dropout_rate: float) -> bool:
    """The fused op covers dropout-free attention with N >= 8 and d >= 8
    (the JAX package's dispatch rule, attention.py:461-463)."""
    return attn_dropout_rate == 0.0 and n >= 8 and d >= 8


def _split(qkv: torch.Tensor, num_heads: int):
    b, n, w3 = qkv.shape
    if w3 % (3 * num_heads):
        raise ValueError(f"qkv width {w3} is not 3 * {num_heads} heads * head_dim")
    d = w3 // (3 * num_heads)
    q, k, v = qkv.float().view(b, n, 3, num_heads, d).unbind(2)
    return q, k, v


def attention_qkv_plain(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """K1's function in plain PyTorch (differentiable by autograd)."""
    b, n, w3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    o = torch.einsum("bhnm,bmhd->bnhd", p, v)
    return o.reshape(b, n, w3 // 3).to(qkv.dtype)


def attention_qkv_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                            num_heads: int) -> torch.Tensor:
    """K2's function in plain PyTorch: the packed cotangent of ``qkv``."""
    b, n, w3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    g = do.float().view(q.shape)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, g)
    dp = torch.einsum("bnhd,bmhd->bhnm", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q) * scale
    return torch.stack([dq, dk, dv], dim=2).reshape(b, n, w3).to(qkv.dtype)


def _lib():
    lib = kernels.library("attention")
    if not getattr(lib, "_vst_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vst_attn_fwd.argtypes = [p, p, i, i, i, i, f, i, p]
        lib.vst_attn_fwd.restype = i
        lib.vst_attn_bwd.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
        lib.vst_attn_bwd.restype = i
        lib.vst_attn_smem_bytes.argtypes = [i, i]
        lib.vst_attn_smem_bytes.restype = ctypes.c_longlong
        lib._vst_typed = True
    return lib


def _check_shape(qkv: torch.Tensor, num_heads: int):
    """Validate a kernel call (before the library is built); returns
    ``(b, n, d, lib)``."""
    kernels.check_cuda_tensor(qkv, "qkv", ndim=3)
    b, n, w3 = qkv.shape
    if w3 % (3 * num_heads):
        raise ValueError(f"qkv width {w3} is not 3 * {num_heads} heads * head_dim")
    d = w3 // (3 * num_heads)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    lib = _lib()
    smem = lib.vst_attn_smem_bytes(n, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"attention kernel needs {smem} bytes of shared memory at "
                         f"N={n}, d={d}; a block has {MAX_SMEM_BYTES}")
    return b, n, d, lib


def attention_qkv_fwd_cuda(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """Launch K1."""
    b, n, d, lib = _check_shape(qkv, num_heads)
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    rc = lib.vst_attn_fwd(qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, scale,
                          kernels.DTYPE_CODES[qkv.dtype], kernels.stream_ptr(qkv))
    kernels.check_launch(rc, "attention forward (K1)")
    K1.launches += 1
    return out


def attention_qkv_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                           num_heads: int) -> torch.Tensor:
    """Launch K2 (its dq pass, then its dk/dv pass)."""
    b, n, d, lib = _check_shape(qkv, num_heads)
    kernels.check_cuda_tensor(do, "do", dtypes=(qkv.dtype,), ndim=3)
    if tuple(do.shape) != (b, n, num_heads * d):
        raise ValueError(f"do shape {tuple(do.shape)} != {(b, n, num_heads * d)}")
    dqkv = torch.empty_like(qkv)
    rowstats = torch.empty((b * num_heads * n, 4), dtype=torch.float32, device=qkv.device)
    rc = lib.vst_attn_bwd(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                          rowstats.data_ptr(), b, n, num_heads, d, scale,
                          kernels.DTYPE_CODES[qkv.dtype], kernels.stream_ptr(qkv))
    kernels.check_launch(rc, "attention backward (K2)")
    K2.launches += 1
    return dqkv


class _FusedAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, scale, num_heads):
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.save_for_backward(qkv)
        if qkv.device.type == "cpu":
            return attention_qkv_plain(qkv, scale, num_heads)
        return attention_qkv_fwd_cuda(qkv, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        g = g.contiguous()
        if qkv.device.type == "cpu":
            return attention_qkv_bwd_plain(qkv, g, ctx.scale, ctx.num_heads), None, None
        return attention_qkv_bwd_cuda(qkv, g, ctx.scale, ctx.num_heads), None, None


def fused_attention_qkv(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` straight off the packed projection."""
    return _FusedAttentionQKV.apply(qkv.contiguous(), float(scale), int(num_heads))
