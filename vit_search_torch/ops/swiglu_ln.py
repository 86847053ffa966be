"""SwiGLU with its sub-LN: EVA-02's MLP between the packed ``W1 | W2`` GEMM
and ``W3``.

:func:`swiglu_ln` takes ``u = [a | b]``, the ``(..., 2P)`` output of one
GEMM over ``W1`` and ``W2`` stacked (with their biases), and the layer norm's
weight and bias of ``H`` channels, and returns ``layer_norm(silu(a) * b)``
over them (float32 statistics, the biased variance, ``eps`` inside the root)
in ``u``'s dtype, ``(..., P)``. ``P >= H`` is the pitch: ``a`` is the first
``H`` columns of ``u``'s first ``P``, ``b`` of its last ``P``; the output's
columns ``H..P-1`` are zeros. A model pads ``H`` to a pitch the GEMMs read at
16 bytes a row (EVA-02-L's 2730 to 2736) by stacking zero rows into ``W1``
and ``W2`` and zero columns into ``W3``; the zeros this op writes meet them.

On the card a bfloat16 call runs G1 (forward: one row a block, ``h`` held in
registers, the variance from a second pass over it; saves only each row's
float32 mean and ``1 / std``) and G2 (backward: the packed ``(da, db)`` and
the norm's weight and bias gradients, whose per-block partials a second
launch folds) of ``csrc/swiglu_ln.cu``. They take any even ``H`` up to 4096
and any odd one up to 2048: no ``% 4`` and no 2048 cap, as K3d/K4d have. A
CPU tensor runs the plain version, float32 PyTorch that autograd
differentiates; a CUDA call the kernels refuse raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .kernels import Kernel

SOURCE = "vit_search_torch/csrc/swiglu_ln.cu"
NONE = "none: the JAX package has no gated MLP"
G1 = kernels.register(Kernel("swiglu_ln_fwd", SOURCE, NONE))
G2 = kernels.register(Kernel("swiglu_ln_bwd", SOURCE, NONE))


# --- plain versions ----------------------------------------------------------------

def _halves(u: torch.Tensor, hidden: int):
    """float32 ``a`` and ``b``, each ``(..., H)``, of ``u = [a | b]``."""
    a, b = u.float().chunk(2, dim=-1)
    return a[..., :hidden], b[..., :hidden]


def swiglu_ln_plain(u: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """G1's function in float32, in ``u``'s dtype; autograd differentiates it."""
    hidden = weight.shape[0]
    a, b = _halves(u, hidden)
    h = F.silu(a) * b
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    y = (h - mu) / torch.sqrt(var + eps)
    y = F.pad(y * weight.float() + bias.float(), (0, u.shape[-1] // 2 - hidden))
    return y.to(u.dtype)


def swiglu_ln_stats_plain(u: torch.Tensor, eps: float, hidden: int) -> torch.Tensor:
    """Each row's float32 ``(mean, 1 / std)`` of ``silu(a) * b``, ``(..., 2)``."""
    a, b = _halves(u, hidden)
    h = F.silu(a) * b
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    return torch.cat([mu, torch.rsqrt(var + eps)], dim=-1)


def swiglu_ln_bwd_plain(u: torch.Tensor, weight: torch.Tensor, stats: torch.Tensor,
                        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """G2's function in float32: ``(du, dweight, dbias)``, ``du`` in ``u``'s
    dtype with zeros past ``H`` in each half, the weight's and bias's
    gradients summed over every row."""
    hidden, pad = weight.shape[0], u.shape[-1] // 2 - weight.shape[0]
    a, b = _halves(u, hidden)
    sig = torch.sigmoid(a)
    mu, rstd = stats[..., :1], stats[..., 1:]
    xhat = (a * sig * b - mu) * rstd
    gf = g.float()[..., :hidden]
    gx = gf * weight.float()
    dh = rstd * (gx - gx.mean(-1, keepdim=True) - xhat * (gx * xhat).mean(-1, keepdim=True))
    da = dh * b * sig * (1.0 + a * (1.0 - sig))
    db = dh * a * sig
    rows = tuple(range(u.ndim - 1))
    du = torch.cat([F.pad(da, (0, pad)), F.pad(db, (0, pad))], dim=-1)
    return du.to(u.dtype), (gf * xhat).sum(rows), gf.sum(rows)


# --- kernels -----------------------------------------------------------------------

def _lib():
    lib = kernels.library("swiglu_ln")
    if not getattr(lib, "_vst_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vst_swiglu_ln_fwd.argtypes = [p, p, p, p, p, i, i, i, f, p]
        lib.vst_swiglu_ln_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.vst_swiglu_ln_fwd.restype = lib.vst_swiglu_ln_bwd.restype = i
        lib.vst_swiglu_ln_max_hidden.argtypes = [i]
        lib.vst_swiglu_ln_bwd_blocks.argtypes = [i, i, i, i]
        lib.vst_swiglu_ln_max_hidden.restype = lib.vst_swiglu_ln_bwd_blocks.restype = i
        lib._vst_typed = True
    return lib


def _check(u: torch.Tensor, hidden: int) -> Tuple[int, int]:
    """``(rows, pitch)`` of a kernel call's ``u`` for ``H = hidden``; raises
    where the kernels do not take it."""
    kernels.check_cuda_tensor(u, "u", dtypes=(torch.bfloat16,))
    width = u.shape[-1]
    pitch = width // 2
    if width % 2 or not 1 <= hidden <= pitch:
        raise ValueError(f"u's last axis must be 2 * P with P >= H = {hidden}, got {width}")
    most = _lib().vst_swiglu_ln_max_hidden(int(hidden % 2 == 0 and pitch % 2 == 0))
    if hidden > most:
        raise ValueError(f"SwiGLU-LN kernel takes H up to {most} at this parity, got {hidden}")
    return u.numel() // width, pitch


def _params(t: torch.Tensor, hidden: int, name: str) -> torch.Tensor:
    t = t.float().contiguous()
    if t.shape != (hidden,):
        raise ValueError(f"{name} shape {tuple(t.shape)} != ({hidden},)")
    kernels.check_cuda_tensor(t, name, dtypes=(torch.float32,), ndim=1)
    return t


def swiglu_ln_fwd_cuda(u: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch G1: ``(y, stats)``, ``stats`` float32 ``(..., 2)``."""
    hidden = weight.shape[0]
    rows, pitch = _check(u, hidden)
    w, b = _params(weight, hidden, "weight"), _params(bias, hidden, "bias")
    y = torch.empty(u.shape[:-1] + (pitch,), dtype=u.dtype, device=u.device)
    stats = torch.empty(u.shape[:-1] + (2,), dtype=torch.float32, device=u.device)
    rc = _lib().vst_swiglu_ln_fwd(u.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                  stats.data_ptr(), rows, hidden, pitch, eps,
                                  kernels.stream_ptr(u))
    kernels.check_launch(rc, "SwiGLU-LN forward (G1)")
    G1.launches += 1
    return y, stats


def swiglu_ln_bwd_cuda(u: torch.Tensor, weight: torch.Tensor, stats: torch.Tensor,
                       g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch G2 (its row pass, then the fold of its partials):
    ``(du, dweight, dbias)``."""
    hidden = weight.shape[0]
    rows, pitch = _check(u, hidden)
    kernels.check_cuda_tensor(g, "g", dtypes=(u.dtype,))
    if g.shape != u.shape[:-1] + (pitch,):
        raise ValueError(f"g shape {tuple(g.shape)} does not fit u {tuple(u.shape)}")
    kernels.check_cuda_tensor(stats, "stats", dtypes=(torch.float32,))
    w = _params(weight, hidden, "weight")
    lib = _lib()
    blocks = lib.vst_swiglu_ln_bwd_blocks(rows, hidden, pitch, kernels.num_sms(u))
    du = torch.empty_like(u)
    dw = torch.empty(hidden, dtype=torch.float32, device=u.device)
    db = torch.empty_like(dw)
    part = torch.empty((blocks, 2, hidden), dtype=torch.float32, device=u.device)
    rc = lib.vst_swiglu_ln_bwd(u.data_ptr(), g.data_ptr(), w.data_ptr(), stats.data_ptr(),
                               du.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
                               blocks, rows, hidden, pitch, kernels.stream_ptr(u))
    kernels.check_launch(rc, "SwiGLU-LN backward (G2)")
    G2.launches += 1
    return du, dw, db


class _SwigluLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, weight, bias, eps):
        y, stats = swiglu_ln_fwd_cuda(u, weight, bias, eps)
        ctx.save_for_backward(u, weight, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        u, weight, stats = ctx.saved_tensors
        du, dw, db = swiglu_ln_bwd_cuda(u, weight, stats, g.contiguous())
        return du, dw.to(weight.dtype), db.to(weight.dtype), None


def swiglu_ln(u: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """``layer_norm(silu(a) * b) * weight + bias`` of ``u = [a | b]``, at
    ``u``'s pitch (``u.shape[-1] // 2``), zeros past ``weight``'s ``H``."""
    if u.device.type == "cpu":
        return swiglu_ln_plain(u, weight, bias, eps)
    return _SwigluLN.apply(u.contiguous(), weight, bias, float(eps))
