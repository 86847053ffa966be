"""Streaming attention with an optional 2D rotary embedding of q and k.

:func:`rope_attention` takes the packed ``(B, N, 3W)`` projection, as
:func:`ops.attention.fused_attention_qkv` does, and optional float32 ``(N,
d)`` ``cos`` and ``sin`` tables. Each adjacent pair of columns ``(x0, x1)``
of q and k becomes ``(x0 c0 - x1 s0, x1 c1 + x0 s1)``: ``x * cos +
rotate_half(x) * sin`` with ``rotate_half`` mapping a pair to ``(-x1, x0)``
(EVA-02's ``VisionRotaryEmbeddingFast``). A row of cos 1 and sin 0 leaves its
token unrotated (EVA-02's cls token). Then ``softmax(q k^T * scale) v``.

On the card a bfloat16 call runs R1 (forward) and R2 (backward) of
``csrc/attention_rope.cu``: K and V streamed in tiles with an online softmax,
so N is not bounded by shared memory; where there are tables, a prep launch
first rotates q and k in float32 into a bf16 scratch (once a call, where
rotating each staged tile cost every block of a head the same tiles again).
The forward saves the output and each row's float32 log-sum-exp; the
backward rotates q and k again, recomputes p from them in two launches (dq,
then dk and dv, no atomics) and rotates dq and dk back. Without tables the
same kernels compute plain attention: ``ops.attention.fused_attention_qkv`` sends them the
bfloat16 calls whose K1/K2 need more shared memory than a block has
(:func:`k1_fits`); every other shape stays on K1/K2. A CPU tensor runs the
plain versions, float32 PyTorch that autograd differentiates; a CUDA call
the kernels refuse raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import attention as A
from . import kernels
from .kernels import Kernel

SOURCE = "vit_search_torch/csrc/attention_rope.cu"
NONE = "none: the JAX package has no rotary or streaming attention"
R1 = kernels.register(Kernel("rope_attention_fwd", SOURCE, NONE))
R2 = kernels.register(Kernel("rope_attention_bwd", SOURCE, NONE))

Tables = Optional[Tuple[torch.Tensor, torch.Tensor]]


# --- the rotation and the plain versions ---------------------------------------

def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Each adjacent pair of the last axis ``(x0, x1)`` to ``(-x1, x0)``."""
    x0, x1 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x1, x0), -1).flatten(-2)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x * cos + rotate_half(x) * sin`` over ``(B, N, H, D)``, tables ``(N, D)``."""
    return x * cos[:, None, :] + rotate_half(x) * sin[:, None, :]


def unrotate(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """:func:`rotate`'s transpose: a pair ``(g0, g1)`` to ``(g0 c0 + g1 s1,
    g1 c1 - g0 s0)``."""
    return g * cos[:, None, :] - rotate_half(g * sin[:, None, :])


def _qkv(qkv: torch.Tensor, tables: Tables, num_heads: int):
    """float32 ``(B, N, H, D)`` q and k (rotated where there are tables) and v."""
    q, k, v = A._split(qkv, num_heads)
    if tables is not None:
        cos, sin = (t.float() for t in tables)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    return q, k, v


def rope_attention_plain(qkv: torch.Tensor, tables: Tables, scale: float,
                         num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """R1's function in float32: ``(out, lse)``, ``out`` in ``qkv``'s dtype,
    ``lse`` the float32 ``(B, H, N)`` log-sum-exp of each row's scaled
    scores. Differentiable by autograd."""
    b, n, w3 = qkv.shape
    q, k, v = _qkv(qkv, tables, num_heads)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", torch.exp(s - lse[..., None]), v)
    return out.reshape(b, n, w3 // 3).to(qkv.dtype), lse


def rope_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor, tables: Tables,
                             scale: float, num_heads: int) -> torch.Tensor:
    """R2's function in float32: the packed cotangent of ``qkv``, dq and dk
    rotated back."""
    b, n, w3 = qkv.shape
    q, k, v = _qkv(qkv, tables, num_heads)
    dq, dk, dv = A._bwd(q, k, v, dout.float().view(q.shape), scale)
    if tables is not None:
        cos, sin = (t.float() for t in tables)
        dq, dk = unrotate(dq, cos, sin), unrotate(dk, cos, sin)
    return torch.stack((dq, dk, dv), dim=2).reshape(b, n, w3).to(qkv.dtype)


# --- kernels -----------------------------------------------------------------------

def _lib():
    lib = kernels.library("attention_rope")
    if not getattr(lib, "_vst_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i, i, i, i, f, p]   # batch, n, heads, d, scale, stream
        lib.vst_rope_attn_fwd.argtypes = [p, p, p, p, p, p] + shape
        lib.vst_rope_attn_bwd.argtypes = [p, p, p, p, p, p, p, p, p] + shape
        lib.vst_rope_attn_fwd.restype = lib.vst_rope_attn_bwd.restype = i
        lib._vst_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def k1_fits(n: int, d: int) -> bool:
    """Whether K1/K2's bfloat16 bodies fit a block's shared memory at ``(N,
    d)`` (their forward and the backward's route, ``vst_attn_smem_bytes``)."""
    lib = A._lib()
    return lib.vst_attn_smem_bytes(n, d, kernels.DTYPE_CODES[torch.bfloat16]) <= A.MAX_SMEM_BYTES


def _check(qkv: torch.Tensor, tables: Tables, num_heads: int):
    kernels.check_cuda_tensor(qkv, "qkv", dtypes=(torch.bfloat16,), ndim=3)
    b, n, w3 = qkv.shape
    d = A._head_dim(w3, 3, num_heads)
    if d not in A.KERNEL_HEAD_DIMS:
        raise ValueError(f"rotary attention kernel takes a head_dim that is a multiple of 8 "
                         f"from 8 to 128, got {d}")
    ptrs = (None, None)
    if tables is not None:
        for t, name in zip(tables, ("cos", "sin")):
            kernels.check_cuda_tensor(t, name, dtypes=(torch.float32,), ndim=2)
            if tuple(t.shape) != (n, d):
                raise ValueError(f"{name} shape {tuple(t.shape)} != {(n, d)}")
        ptrs = tuple(t.data_ptr() for t in tables)
    return b, n, d, ptrs


def _scratch(qkv: torch.Tensor, tables: Tables) -> torch.Tensor:
    """The prep launch's ``(B, N, 2W)`` rotated q and k (empty without tables)."""
    b, n, w3 = qkv.shape
    return torch.empty((b, n, 2 * w3 // 3) if tables is not None else (0,), dtype=qkv.dtype,
                       device=qkv.device)


def rope_attention_fwd_cuda(qkv: torch.Tensor, tables: Tables, scale: float,
                            num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch R1 (after the prep launch where there are tables): ``(out, lse)``."""
    b, n, d, (cs, sn) = _check(qkv, tables, num_heads)
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    scratch = _scratch(qkv, tables)
    rc = _lib().vst_rope_attn_fwd(qkv.data_ptr(), cs, sn, scratch.data_ptr(), out.data_ptr(),
                                  lse.data_ptr(), b, n, num_heads, d, scale,
                                  kernels.stream_ptr(qkv))
    kernels.check_launch(rc, "rotary attention forward (R1)")
    R1.launches += 1
    return out, lse


def rope_attention_bwd_cuda(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                            dout: torch.Tensor, tables: Tables, scale: float,
                            num_heads: int) -> torch.Tensor:
    """Launch R2 (after the prep launch where there are tables, its dq pass,
    then its dk/dv pass): the packed cotangent."""
    b, n, d, (cs, sn) = _check(qkv, tables, num_heads)
    for t, name in ((out, "out"), (dout, "dout")):
        A._check_like(t, name, qkv, (b, n, num_heads * d))
    kernels.check_cuda_tensor(lse, "lse", dtypes=(torch.float32,), ndim=3)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    scratch = _scratch(qkv, tables)
    rc = _lib().vst_rope_attn_bwd(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                  lse.data_ptr(), cs, sn, scratch.data_ptr(), dqkv.data_ptr(),
                                  delta.data_ptr(), b, n, num_heads, d, scale,
                                  kernels.stream_ptr(qkv))
    kernels.check_launch(rc, "rotary attention backward (R2)")
    R2.launches += 1
    return dqkv


class _RopeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, cos, sin, scale, num_heads):
        tables = None if cos is None else (cos, sin)
        out, lse = rope_attention_fwd_cuda(qkv, tables, scale, num_heads)
        ctx.scale, ctx.num_heads, ctx.rope = scale, num_heads, tables is not None
        ctx.save_for_backward(qkv, out, lse, *(tables or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse, *tables = ctx.saved_tensors
        dqkv = rope_attention_bwd_cuda(qkv, out, lse, g.contiguous(),
                                       tuple(tables) if ctx.rope else None, ctx.scale,
                                       ctx.num_heads)
        return dqkv, None, None, None, None


def rope_attention(qkv: torch.Tensor, tables: Tables, scale: float,
                   num_heads: int) -> torch.Tensor:
    """``softmax(rot(q) rot(k)^T * scale) v`` off the packed ``(B, N, 3W)``
    projection; ``tables`` is ``(cos, sin)``, each float32 ``(N, d)``, or
    ``None`` (no rotation)."""
    if qkv.device.type == "cpu":
        return rope_attention_plain(qkv, tables, scale, num_heads)[0]
    cos, sin = (None, None) if tables is None else (t.contiguous() for t in tables)
    return _RopeAttention.apply(qkv.contiguous(), cos, sin, float(scale), int(num_heads))
