"""Windowed scaled-cosine attention with a learned position bias (SwinV2).

New in the port (the JAX package has no windowed attention, so no Pallas
kernel precedes it). :func:`window_attention` takes the packed ``(B * nW,
N, 3C)`` projection of every window (column blocks ``[q | k | v]``, each
ordered by head), the per-head ``scale = exp(min(logit_scale, ln 100))``,
the ``(H, N, N)`` position bias and, for a shifted block, each token's
region id in its window, ``(nW, N)`` int32, and returns ``(B * nW, N, C)``:

    s = scale_h * cos(q_i, k_j) + bias[h, i, j] + (-100 where region_i != region_j)
    out = softmax_rows(s) v

Its gradient reaches the projection, the scale and the bias (summed over
every window of every image). A CPU tensor runs :func:`window_attention_plain`
under autograd; a CUDA tensor runs the kernels of
``csrc/window_attention.cu`` (bfloat16, head dim 32, N = 16, 64 or 256), or
the call raises. On the card the forward is one counted call of
``window_attention_fwd`` (the cosine prep and the attention, two launches),
the backward one of ``window_attention_bwd`` (dq, dk/dv with the bias
gradient's partials, the prep's backward with the scale's partials, and the
two folds: five launches). Scores and softmax run in float32; p and ds are
bfloat16 only as operands of their products; q' = scale * q / |q| and k / |k|
are rounded to bfloat16 once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels
from .kernels import Kernel

SOURCE = "vit_search_torch/csrc/window_attention.cu"
NEW = "none: new in the port (SwinV2's windowed cosine attention)"
WA_FWD = kernels.register(Kernel("window_attention_fwd", SOURCE, NEW))
WA_BWD = kernels.register(Kernel("window_attention_bwd", SOURCE, NEW))

KERNEL_HEAD_DIM = 32
KERNEL_LENGTHS = (16, 64, 256)
MASK_FILL = -100.0
THREADS = 256
PREP_BLOCKS_PER_SM = 4


def region_mask(regions: torch.Tensor) -> torch.Tensor:
    """Swin's ``(nW, N, N)`` attention mask from each token's region id:
    -100 between tokens of different regions, else 0."""
    r = regions.long()
    return (r[:, :, None] != r[:, None, :]).float() * MASK_FILL


def _through_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, the gradient passed straight through."""
    return t + (t.bfloat16().float() - t).detach()


def window_attention_plain(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           regions: Optional[torch.Tensor], num_heads: int,
                           rounded: bool = False) -> torch.Tensor:
    """The function in plain PyTorch (differentiable by autograd): scores
    and softmax in float32, p rounded to ``qkv``'s dtype before ``p v``.
    With ``rounded``, q' = scale * q / |q| and k' = k / |k| are rounded to
    bfloat16 as the kernels' prep rounds them (straight through for the
    gradient): at a scale near 100 that rounding alone moves a score by
    about 0.2, the input's precision and not the kernels' error."""
    bw, n, w3 = qkv.shape
    c = w3 // 3
    q, k, v = qkv.float().view(bw, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    q, k, scale = F.normalize(q, dim=-1), F.normalize(k, dim=-1), scale.float()
    if rounded:
        s = _through_bf16(q * scale.view(1, num_heads, 1, 1)) @ _through_bf16(k).transpose(-2, -1)
    else:
        s = (q @ k.transpose(-2, -1)) * scale.view(1, num_heads, 1, 1)
    s = s + bias.float()
    if regions is not None:
        nwin = regions.shape[0]
        s = (s.view(bw // nwin, nwin, num_heads, n, n)
             + region_mask(regions)[None, :, None]).view(bw, num_heads, n, n)
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    return (p @ v).transpose(1, 2).reshape(bw, n, c).to(qkv.dtype)


# --- kernels --------------------------------------------------------------

def _lib():
    lib = kernels.library("window_attention")
    if not getattr(lib, "_vst_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vst_wattn_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.vst_wattn_bwd.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.vst_wattn_fwd.restype = lib.vst_wattn_bwd.restype = i
        lib._vst_typed = True
    return lib


def _groups(windows: int, num_heads: int, n: int, sms: int) -> int:
    """Windows that share a block's bias rows: one block per SM over the
    launch's (head, part) pairs, a part being up to 128 rows."""
    parts = max(1, n // 128)
    return max(1, min(windows, sms // (num_heads * parts)))


def _check(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           regions: Optional[torch.Tensor], num_heads: int):
    """Validate a kernel call; returns ``(bw, n, d, nwin)``."""
    kernels.check_cuda_tensor(qkv, "qkv", dtypes=(torch.bfloat16,), ndim=3)
    bw, n, w3 = qkv.shape
    if w3 % (3 * num_heads):
        raise ValueError(f"width {w3} is not 3 * {num_heads} heads * head_dim")
    d = w3 // (3 * num_heads)
    if d != KERNEL_HEAD_DIM or n not in KERNEL_LENGTHS or THREADS % num_heads:
        raise ValueError(f"window attention kernel takes head_dim {KERNEL_HEAD_DIM}, N in "
                         f"{KERNEL_LENGTHS} and a head count dividing {THREADS}; got d={d}, "
                         f"N={n}, heads={num_heads}")
    kernels.check_cuda_tensor(scale, "scale", dtypes=(torch.float32,), ndim=1)
    kernels.check_cuda_tensor(bias, "bias", dtypes=(torch.float32,), ndim=3)
    if tuple(scale.shape) != (num_heads,) or tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"scale {tuple(scale.shape)} / bias {tuple(bias.shape)} do not fit "
                         f"{num_heads} heads of {n} tokens")
    nwin = 1
    if regions is not None:
        kernels.check_cuda_tensor(regions, "regions", dtypes=(torch.int32,), ndim=2)
        nwin = regions.shape[0]
        if regions.shape[1] != n or bw % nwin:
            raise ValueError(f"regions {tuple(regions.shape)} do not fit {bw} windows of {n}")
    return bw, n, d, nwin


def _launch_shape(qkv: torch.Tensor, bw: int, n: int, num_heads: int):
    sms = kernels.num_sms(qkv)
    items = bw * n * num_heads
    return (_groups(bw, num_heads, n, sms),
            max(1, min(-(-items // THREADS), PREP_BLOCKS_PER_SM * sms)))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def window_attention_fwd_cuda(qkv, scale, bias, regions, num_heads):
    """The forward's two launches: ``(out, qkvn, rn)``, ``qkvn`` the packed
    ``[q' | k' | v]`` and ``rn`` each (token, head)'s ``(1/|q|, 1/|k|)``."""
    bw, n, d, nwin = _check(qkv, scale, bias, regions, num_heads)
    groups, prep_blocks = _launch_shape(qkv, bw, n, num_heads)
    qkvn = torch.empty_like(qkv)
    rn = torch.empty((bw * n * num_heads, 2), dtype=torch.float32, device=qkv.device)
    out = torch.empty((bw, n, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    rc = _lib().vst_wattn_fwd(qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(regions),
                              qkvn.data_ptr(), rn.data_ptr(), out.data_ptr(), bw, n, num_heads,
                              d, nwin, groups, prep_blocks, kernels.stream_ptr(qkv))
    kernels.check_launch(rc, "window attention forward")
    WA_FWD.launches += 1
    return out, qkvn, rn


def window_attention_bwd_cuda(qkvn, rn, scale, bias, regions, g, num_heads):
    """The backward's launches: ``(dqkv, dscale, dbias)``, the last two in
    float32."""
    bw, n, d, nwin = _check(qkvn, scale, bias, regions, num_heads)
    kernels.check_cuda_tensor(g, "g", dtypes=(qkvn.dtype,), ndim=3)
    if tuple(g.shape) != (bw, n, num_heads * d):
        raise ValueError(f"g shape {tuple(g.shape)} != {(bw, n, num_heads * d)}")
    groups, prep_blocks = _launch_shape(qkvn, bw, n, num_heads)
    dev = qkvn.device
    dqkv = torch.empty_like(qkvn)
    stats = torch.empty((bw * num_heads * n, 4), dtype=torch.float32, device=dev)
    dbias_part = torch.empty((groups, num_heads, n, n), dtype=torch.float32, device=dev)
    dbias = torch.empty((num_heads, n, n), dtype=torch.float32, device=dev)
    dscale_part = torch.empty((prep_blocks, num_heads), dtype=torch.float32, device=dev)
    dscale = torch.empty((num_heads,), dtype=torch.float32, device=dev)
    rc = _lib().vst_wattn_bwd(qkvn.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                              _ptr(regions), rn.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                              stats.data_ptr(), dbias_part.data_ptr(), dbias.data_ptr(),
                              dscale_part.data_ptr(), dscale.data_ptr(), bw, n, num_heads, d,
                              nwin, groups, prep_blocks, kernels.stream_ptr(qkvn))
    kernels.check_launch(rc, "window attention backward")
    WA_BWD.launches += 1
    return dqkv, dscale, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, scale, bias, regions, num_heads):
        out, qkvn, rn = window_attention_fwd_cuda(qkv, scale, bias, regions, num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkvn, rn, scale, bias, regions)
        return out

    @staticmethod
    def backward(ctx, g):
        qkvn, rn, scale, bias, regions = ctx.saved_tensors
        dqkv, dscale, dbias = window_attention_bwd_cuda(qkvn, rn, scale, bias, regions,
                                                        g.contiguous(), ctx.num_heads)
        return dqkv, dscale, dbias, None, None


def window_attention(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     regions: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """Attention within each window (see the module docstring)."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, scale, bias, regions, num_heads)
    return _WindowAttention.apply(qkv.contiguous(), scale.float().contiguous(),
                                  bias.float().contiguous(),
                                  None if regions is None else regions.int().contiguous(),
                                  int(num_heads))

