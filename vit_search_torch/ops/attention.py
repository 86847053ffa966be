"""Fused multi-head attention over three layouts of q, k and v.

Port of vit_search_tpu/ops/pallas/attention.py. Three entry points, one per
layout, each an autograd function whose backward recomputes the
probabilities from the inputs (its only residuals):

- :func:`fused_attention_qkv` (``attention.py:247``): the ``(B, N, 3W)``
  projection output with column blocks ``[q | k | v]``, each ordered by
  head, to ``(B, N, W)``; the backward returns the packed ``(B, N, 3W)``
  cotangent. Kernels K1 (forward) and K2 (backward).
- :func:`fused_attention_packed` (``attention.py:198``): separate ``(B, N,
  W)`` q, k and v, three cotangents; :func:`fused_attention` takes ``(B, N,
  H, D)`` tensors through it. Kernels K6 and K7.
- :func:`fused_attention_qkv_t` (``attention.py:435``): the sequence-major
  ``(N, B, 3W)`` projection to ``(N, B, W)``. Kernels K8 and K9.

Every kernel is in ``csrc/attention.cu`` and computes the same function:
scores and softmax in float32, probabilities cast to the value dtype before
``p @ v`` (summed in float32); the backward from the recomputed float32
``p``. On the card a bfloat16 call takes the tensor-core body, whose
backward rounds ``p`` and ``ds`` to bfloat16 as operands of its products
(``delta`` and ``ds`` are still formed in float32), and a float32 call the
CUDA-core body, all in float32. A bfloat16 backward whose one-launch body
does not fit in shared memory (N past 624 at d = 32) takes the split
backward of ``csrc/attention_tc.cuh`` instead, two launches counted as one
call of its kernel; the choice is fixed by ``(N, d)``. Past the split's
reach (N past 640 at d = 64), :func:`fused_attention_qkv` takes the
streaming kernels of ``ops/rope_attention.py``. The plain versions
are the float32 function. The JAX module's VMEM budgeting (``_pick_group``,
``_pick_group_t``, ``_params_t`` and ``VST_ATTN_T_VMEM_MB``) sizes TPU
blocks and has no counterpart: on the card every layout runs one block per
(example, head).

Beside each kernel a plain PyTorch version computes the same function. A
CPU tensor goes through the plain versions; a CUDA tensor goes through the
kernels, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import kernels
from .kernels import Kernel

SOURCE = "vit_search_torch/csrc/attention.cu"
PALLAS = "vit_search_tpu/ops/pallas/attention.py"
K1 = kernels.register(Kernel("attention_qkv_fwd", SOURCE, f"{PALLAS}:88"))
K2 = kernels.register(Kernel("attention_qkv_bwd", SOURCE, f"{PALLAS}:108"))
K6 = kernels.register(Kernel("attention_fwd", SOURCE, f"{PALLAS}:46"))
K7 = kernels.register(Kernel("attention_bwd", SOURCE, f"{PALLAS}:62"))
K8 = kernels.register(Kernel("attention_qkv_t_fwd", SOURCE, f"{PALLAS}:306"))
K9 = kernels.register(Kernel("attention_qkv_t_bwd", SOURCE, f"{PALLAS}:331"))

# the head dims the kernels take: rows move in 16-byte copies of 8 bf16, and
# a head of at most 128 columns fits the kernels' tiles
KERNEL_HEAD_DIMS = tuple(range(8, 129, 8))
MAX_SMEM_BYTES = 232448


def supported(n: int, d: int, attn_dropout_rate: float) -> bool:
    """The fused op covers dropout-free attention with N >= 8 and a head dim
    in :data:`KERNEL_HEAD_DIMS`.

    Narrower than the JAX package's rule (any d >= 8, attention.py:461-463):
    the card's kernels copy rows in 16-byte pieces and hold at most 128
    columns, so a head dim off that grid goes to :func:`attention_qkv_plain`,
    the same function, as the JAX model sends shapes outside its kernel's
    rule to XLA."""
    return attn_dropout_rate == 0.0 and n >= 8 and d in KERNEL_HEAD_DIMS


# --- plain versions -------------------------------------------------------

def _head_dim(width: int, parts: int, num_heads: int) -> int:
    if width % (parts * num_heads):
        raise ValueError(f"width {width} is not {parts} * {num_heads} heads * head_dim")
    return width // (parts * num_heads)


def _split(qkv: torch.Tensor, num_heads: int):
    """float32 ``(B, N, H, D)`` views of q, k and v in a ``(B, N, 3W)`` tensor."""
    b, n, w3 = qkv.shape
    return qkv.float().view(b, n, 3, num_heads, _head_dim(w3, 3, num_heads)).unbind(2)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, w = x.shape
    return x.float().view(b, n, num_heads, _head_dim(w, 1, num_heads))


def _fwd(q, k, v, scale: float, p_dtype: torch.dtype) -> torch.Tensor:
    """float32 ``(B, N, H, D)`` q, k, v -> float32 ``(B, N, H, D)``; p is
    rounded to ``p_dtype`` (v's dtype) before ``p @ v``."""
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.softmax(s, dim=-1).to(p_dtype).float()
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


def _bwd(q, k, v, g, scale: float):
    """float32 ``(B, N, H, D)`` q, k, v and cotangent -> dq, dk, dv, all f32."""
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, g)
    dp = torch.einsum("bnhd,bmhd->bhnm", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q) * scale
    return dq, dk, dv


def attention_qkv_plain(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """K1's function in plain PyTorch (differentiable by autograd)."""
    b, n, w3 = qkv.shape
    o = _fwd(*_split(qkv, num_heads), scale, qkv.dtype)
    return o.reshape(b, n, w3 // 3).to(qkv.dtype)


def attention_qkv_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                            num_heads: int) -> torch.Tensor:
    """K2's function in plain PyTorch: the packed cotangent of ``qkv``."""
    b, n, w3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    grads = _bwd(q, k, v, do.float().view(q.shape), scale)
    return torch.stack(grads, dim=2).reshape(b, n, w3).to(qkv.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    num_heads: int) -> torch.Tensor:
    """K6's function in plain PyTorch: separate ``(B, N, W)`` q, k, v."""
    o = _fwd(*(_heads(t, num_heads) for t in (q, k, v)), scale, v.dtype)
    return o.reshape(q.shape).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                        scale: float, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """K7's function in plain PyTorch: ``(dq, dk, dv)``, each ``(B, N, W)``."""
    grads = _bwd(*(_heads(t, num_heads) for t in (q, k, v, do)), scale)
    return tuple(g.reshape(q.shape).to(q.dtype) for g in grads)


def attention_qkv_t_plain(qkv_t: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """K8's function in plain PyTorch: ``(N, B, 3W) -> (N, B, W)``."""
    return attention_qkv_plain(qkv_t.transpose(0, 1), scale, num_heads).transpose(0, 1)


def attention_qkv_t_bwd_plain(qkv_t: torch.Tensor, do_t: torch.Tensor, scale: float,
                              num_heads: int) -> torch.Tensor:
    """K9's function in plain PyTorch: the ``(N, B, 3W)`` cotangent of ``qkv_t``."""
    return attention_qkv_bwd_plain(qkv_t.transpose(0, 1), do_t.transpose(0, 1), scale,
                                   num_heads).transpose(0, 1)


# --- kernels --------------------------------------------------------------

def _lib():
    lib = kernels.library("attention")
    if not getattr(lib, "_vst_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i, i, i, i, f, i, p]   # batch, n, heads, d, scale, dtype, stream
        lib.vst_attn_fwd.argtypes = [p, p] + shape
        lib.vst_attn_bwd.argtypes = [p, p, p, p] + shape
        lib.vst_attn_fwd_sep.argtypes = [p, p, p, p] + shape
        lib.vst_attn_bwd_sep.argtypes = [p, p, p, p, p, p, p, p] + shape
        lib.vst_attn_fwd_t.argtypes = [p, p] + shape
        lib.vst_attn_bwd_t.argtypes = [p, p, p, p] + shape
        for fn in (lib.vst_attn_fwd, lib.vst_attn_bwd, lib.vst_attn_fwd_sep,
                   lib.vst_attn_bwd_sep, lib.vst_attn_fwd_t, lib.vst_attn_bwd_t):
            fn.restype = i
        lib.vst_attn_smem_bytes.argtypes = [i, i, i]
        lib.vst_attn_smem_bytes.restype = ctypes.c_longlong
        lib.vst_attn_bwd_split.argtypes = [i, i]
        lib.vst_attn_bwd_split.restype = i
        lib._vst_typed = True
    return lib


def _check(x: torch.Tensor, name: str, parts: int, num_heads: int, seq_major: bool = False):
    """Validate the first operand of a kernel call (before the library is
    built): a contiguous 3-D CUDA tensor, ``(B, N, parts * heads * d)`` or,
    ``seq_major``, ``(N, B, ...)``. Returns ``(b, n, d, lib)``."""
    kernels.check_cuda_tensor(x, name, ndim=3)
    b, n, width = x.shape
    if seq_major:
        b, n = n, b
    d = _head_dim(width, parts, num_heads)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes a head_dim that is a multiple of 8 "
                         f"from 8 to 128, got {d}")
    lib = _lib()
    smem = lib.vst_attn_smem_bytes(n, d, kernels.DTYPE_CODES[x.dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"attention kernel needs {smem} bytes of shared memory at "
                         f"N={n}, d={d}; a block has {MAX_SMEM_BYTES}")
    return b, n, d, lib


def _check_like(x: torch.Tensor, name: str, like: torch.Tensor, shape) -> None:
    kernels.check_cuda_tensor(x, name, dtypes=(like.dtype,), ndim=3)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")


def _args(*tensors):
    """The tensors' data pointers, the first arguments of every entry point."""
    return [t.data_ptr() for t in tensors]


def _tail(x: torch.Tensor, batch: int, n: int, num_heads: int, d: int, scale: float):
    """The arguments after the pointers: shape, scale, dtype code, stream."""
    return [batch, n, num_heads, d, scale, kernels.DTYPE_CODES[x.dtype], kernels.stream_ptr(x)]


def backward_is_split(n: int, d: int) -> bool:
    """Whether a bfloat16 backward at ``(N, d)`` takes the split route (a dq
    launch, then a dk/dv launch) rather than the one-launch body."""
    return bool(_lib().vst_attn_bwd_split(n, d))


def _rowstats(x: torch.Tensor, batch: int, n: int, num_heads: int) -> torch.Tensor:
    """A backward's scratch: each query row's (max, sum, delta), float32, for
    the float32 body's two launches. The bfloat16 bodies keep them on chip
    and never read their (empty) scratch."""
    rows = batch * num_heads * n if x.dtype == torch.float32 else 0
    return torch.empty((rows, 4), dtype=torch.float32, device=x.device)


def attention_qkv_fwd_cuda(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """Launch K1."""
    b, n, d, lib = _check(qkv, "qkv", 3, num_heads)
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    rc = lib.vst_attn_fwd(*_args(qkv, out), *_tail(qkv, b, n, num_heads, d, scale))
    kernels.check_launch(rc, "attention forward (K1)")
    K1.launches += 1
    return out


def attention_qkv_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                           num_heads: int) -> torch.Tensor:
    """Launch K2 (bf16: one launch, or the split route's two; f32: its dq
    pass, then its dk/dv pass)."""
    b, n, d, lib = _check(qkv, "qkv", 3, num_heads)
    _check_like(do, "do", qkv, (b, n, num_heads * d))
    dqkv = torch.empty_like(qkv)
    rc = lib.vst_attn_bwd(*_args(qkv, do, dqkv, _rowstats(qkv, b, n, num_heads)),
                          *_tail(qkv, b, n, num_heads, d, scale))
    kernels.check_launch(rc, "attention backward (K2)")
    K2.launches += 1
    return dqkv


def attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                       num_heads: int) -> torch.Tensor:
    """Launch K6."""
    b, n, d, lib = _check(q, "q", 1, num_heads)
    _check_like(k, "k", q, q.shape)
    _check_like(v, "v", q, q.shape)
    out = torch.empty_like(q)
    rc = lib.vst_attn_fwd_sep(*_args(q, k, v, out), *_tail(q, b, n, num_heads, d, scale))
    kernels.check_launch(rc, "attention forward (K6)")
    K6.launches += 1
    return out


def attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       scale: float, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """Launch K7 (bf16: one launch, or the split route's two; f32: its dq
    pass, then its dk/dv pass): ``(dq, dk, dv)``."""
    b, n, d, lib = _check(q, "q", 1, num_heads)
    for t, name in ((k, "k"), (v, "v"), (do, "do")):
        _check_like(t, name, q, q.shape)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rc = lib.vst_attn_bwd_sep(*_args(q, k, v, do, dq, dk, dv, _rowstats(q, b, n, num_heads)),
                              *_tail(q, b, n, num_heads, d, scale))
    kernels.check_launch(rc, "attention backward (K7)")
    K7.launches += 1
    return dq, dk, dv


def attention_qkv_t_fwd_cuda(qkv_t: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """Launch K8 on the sequence-major ``(N, B, 3W)`` projection."""
    b, n, d, lib = _check(qkv_t, "qkv_t", 3, num_heads, seq_major=True)
    out_t = torch.empty((n, b, num_heads * d), dtype=qkv_t.dtype, device=qkv_t.device)
    rc = lib.vst_attn_fwd_t(*_args(qkv_t, out_t), *_tail(qkv_t, b, n, num_heads, d, scale))
    kernels.check_launch(rc, "attention forward, sequence-major (K8)")
    K8.launches += 1
    return out_t


def attention_qkv_t_bwd_cuda(qkv_t: torch.Tensor, do_t: torch.Tensor, scale: float,
                             num_heads: int) -> torch.Tensor:
    """Launch K9 (bf16: one launch, or the split route's two; f32: its dq
    pass, then its dk/dv pass): the ``(N, B, 3W)`` cotangent."""
    b, n, d, lib = _check(qkv_t, "qkv_t", 3, num_heads, seq_major=True)
    _check_like(do_t, "do_t", qkv_t, (n, b, num_heads * d))
    dqkv_t = torch.empty_like(qkv_t)
    rc = lib.vst_attn_bwd_t(*_args(qkv_t, do_t, dqkv_t, _rowstats(qkv_t, b, n, num_heads)),
                            *_tail(qkv_t, b, n, num_heads, d, scale))
    kernels.check_launch(rc, "attention backward, sequence-major (K9)")
    K9.launches += 1
    return dqkv_t


# --- autograd functions and entry points ----------------------------------

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


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return attention_plain(q, k, v, scale, num_heads)
        return attention_fwd_cuda(q, k, v, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.contiguous()
        if q.device.type == "cpu":
            grads = attention_bwd_plain(q, k, v, g, ctx.scale, ctx.num_heads)
        else:
            grads = attention_bwd_cuda(q, k, v, g, ctx.scale, ctx.num_heads)
        return (*grads, None, None)


class _FusedAttentionQKVT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv_t, scale, num_heads):
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.save_for_backward(qkv_t)
        if qkv_t.device.type == "cpu":
            return attention_qkv_t_plain(qkv_t, scale, num_heads)
        return attention_qkv_t_fwd_cuda(qkv_t, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv_t,) = ctx.saved_tensors
        g = g.contiguous()
        if qkv_t.device.type == "cpu":
            return attention_qkv_t_bwd_plain(qkv_t, g, ctx.scale, ctx.num_heads), None, None
        return attention_qkv_t_bwd_cuda(qkv_t, g, ctx.scale, ctx.num_heads), None, None


def fused_attention_qkv(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` straight off the packed projection. A
    bfloat16 CUDA call whose K1/K2 do not fit a block's shared memory runs
    the streaming kernels R1/R2 (``ops.rope_attention``, no tables) instead;
    the choice is fixed by ``(N, d)``."""
    if qkv.is_cuda and qkv.dtype == torch.bfloat16 and _streams(qkv.shape[1], qkv.shape[2],
                                                                  num_heads):
        from .rope_attention import rope_attention

        return rope_attention(qkv, None, scale, num_heads)
    return _FusedAttentionQKV.apply(qkv.contiguous(), float(scale), int(num_heads))


@functools.lru_cache(maxsize=None)
def _streams(n: int, width: int, num_heads: int) -> bool:
    """Whether a bfloat16 CUDA call of ``fused_attention_qkv`` at ``(N,
    3W)`` takes R1/R2: K1/K2 do not fit a block's shared memory there.
    Resolved once a shape."""
    from .rope_attention import k1_fits

    d = _head_dim(width, 3, num_heads)
    return d in KERNEL_HEAD_DIMS and not k1_fits(n, d)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           num_heads: int) -> torch.Tensor:
    """Multi-head attention over separate ``(B, N, H*D)`` q, k and v."""
    return _FusedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), float(scale),
                                 int(num_heads))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``softmax(q @ k^T * scale) @ v`` over ``(B, N, H, D)`` inputs."""
    b, n, h, d = q.shape
    out = fused_attention_packed(q.reshape(b, n, h * d), k.reshape(b, n, h * d),
                                 v.reshape(b, n, h * d), scale, h)
    return out.reshape(b, n, h, d)


def fused_attention_qkv_t(qkv_t: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """Sequence-major fused attention: ``(N, B, 3W) -> (N, B, W)``."""
    return _FusedAttentionQKVT.apply(qkv_t.contiguous(), float(scale), int(num_heads))
