"""Supernet prefix masks and stochastic depth inside the elementwise passes.

Every supernet mask keeps a prefix of channels (``ops/masking.py``): the mask
of example ``b`` is ``c < n[b]`` for a ``(B,)`` int32 count vector ``n``, the
per-example counts of ``models.supernet.build_arch_masks``. Drop path scales
example ``b``'s residual branch by ``s[b] = keep[b] / keep_prob`` (float32
``(B,)``). Three functions apply them where the data is read anyway:

- :func:`prefix_gelu` (M1): ``gelu(h) * [c < n_b]``, exact erf or tanh; its
  backward ``gelu'(h) * g * [c < n_b]``. Saves ``h`` and ``n``, as ``F.gelu``
  saves ``h``.
- :func:`branch_add` (M2): ``x + f * s_b * [c < n_b]``, the residual add with
  the branch's mask and drop path's scale; its backward is ``g`` for ``x`` (no
  launch) and M3 for ``f``.
- :func:`prefix_scale` (M3): ``g * s_b * [c < n_b]``; its backward is itself.

``n`` or ``s`` may be ``None``: every channel kept, a scale of 1. The tensors
are ``(B, ..., C)``, with ``B`` the counts' length. A CUDA tensor runs the
kernels of ``csrc/prefix_mask.cu`` (each launch counted on its record) or the
call raises; a CPU tensor runs the plain versions, PyTorch ops in float32
rounded once, which autograd differentiates.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels
from .kernels import Kernel
from .row_draws import uniform

SOURCE = "vit_search_torch/csrc/prefix_mask.cu"
NONE = ("none: the JAX package's mask multiplies and drop path are jnp ops that XLA fuses "
        "(vit_search_tpu/models/layers.py)")
GELU_FWD = kernels.register(Kernel("prefix_gelu_fwd", SOURCE, NONE))
GELU_BWD = kernels.register(Kernel("prefix_gelu_bwd", SOURCE, NONE))
BRANCH_ADD = kernels.register(Kernel("branch_add", SOURCE, NONE))
SCALE = kernels.register(Kernel("prefix_scale", SOURCE, NONE))

GELU_FORMS = {"exact": "none", "tanh": "tanh"}
MAX_ELEMENTS = 2 ** 31 - 1


def kernel_route(t: torch.Tensor) -> bool:
    """Whether a model applies its masks to ``t`` as keep counts through these
    functions: a CUDA tensor does; a CPU tensor keeps the boolean multiplies,
    op for op, which the parity tests hold to the JAX package's bits."""
    return t.is_cuda


def drop_path_scale(batch: int, rate: float, device, keep: Optional[torch.Tensor] = None,
                    generator=None) -> torch.Tensor:
    """Drop path's ``(B,)`` float32 scale ``keep / (1 - rate)``; the keeps are
    ``keep`` when given, else drawn as ``ops.drop_path`` draws them."""
    keep_prob = 1.0 - rate
    if keep is None:
        keep = uniform((batch,), device, generator) < keep_prob
    return keep.to(device=device, dtype=torch.float32) / keep_prob


def _factor(like: torch.Tensor, counts: Optional[torch.Tensor],
            scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``s_b * [c < n_b]`` as a float32 tensor that broadcasts over ``like``."""
    shape = (like.shape[0],) + (1,) * (like.ndim - 1)
    n = like.shape[-1] if counts is None else counts.to(torch.int64).view(shape)
    keep = (torch.arange(like.shape[-1], device=like.device) < n).float()
    return keep if scale is None else keep * scale.to(torch.float32).view(shape)


def prefix_gelu_plain(h: torch.Tensor, counts: Optional[torch.Tensor],
                      gelu: str) -> torch.Tensor:
    return (F.gelu(h.float(), approximate=GELU_FORMS[gelu])
            * _factor(h, counts, None)).to(h.dtype)


def branch_add_plain(x: torch.Tensor, f: torch.Tensor, counts: Optional[torch.Tensor],
                     scale: Optional[torch.Tensor]) -> torch.Tensor:
    return (x.float() + f.float() * _factor(f, counts, scale)).to(x.dtype)


def prefix_scale_plain(g: torch.Tensor, counts: Optional[torch.Tensor],
                       scale: Optional[torch.Tensor]) -> torch.Tensor:
    return (g.float() * _factor(g, counts, scale)).to(g.dtype)


def _lib():
    lib = kernels.library("prefix_mask")
    if not getattr(lib, "_vst_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vst_prefix_gelu_fwd.argtypes = [p, p, p, ll, i, i, i, i, p]
        lib.vst_prefix_gelu_bwd.argtypes = [p, p, p, p, ll, i, i, i, i, p]
        lib.vst_branch_add.argtypes = [p, p, p, p, p, ll, i, i, i, p]
        lib.vst_prefix_scale.argtypes = [p, p, p, p, ll, i, i, i, p]
        for fn in (lib.vst_prefix_gelu_fwd, lib.vst_prefix_gelu_bwd, lib.vst_branch_add,
                   lib.vst_prefix_scale):
            fn.restype = i
        lib._vst_typed = True
    return lib


def _check(counts: Optional[torch.Tensor], scale: Optional[torch.Tensor],
           **tensors: torch.Tensor):
    """``(rows, N, C, dtype code, counts ptr, scale ptr)`` of ``(B, ..., C)``
    operands that the kernels take; raises on anything else."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        kernels.check_cuda_tensor(t, name, align=t.element_size())
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match "
                             f"{tuple(first.shape)} {first.dtype}")
    if first.ndim < 2:
        raise ValueError(f"the prefix kernels need (B, ..., C) tensors, got {tuple(first.shape)}")
    b, c = first.shape[0], first.shape[-1]
    for name, v, dtype in (("counts", counts, torch.int32), ("scale", scale, torch.float32)):
        if v is not None:
            kernels.check_cuda_tensor(v, name, dtypes=(dtype,), ndim=1, align=4)
            if v.shape[0] != b or v.device != first.device:
                raise ValueError(f"{name} of shape {tuple(v.shape)} on {v.device} for a batch "
                                 f"of {b} on {first.device}")
    if first.numel() > MAX_ELEMENTS:
        raise ValueError(f"the prefix kernels take at most {MAX_ELEMENTS} elements, got "
                         f"{first.numel()}")
    rows = first.numel() // c
    return (rows, rows // b if b else 1, c, kernels.DTYPE_CODES[first.dtype],
            None if counts is None else counts.data_ptr(),
            None if scale is None else scale.data_ptr())


def prefix_gelu_fwd_cuda(h: torch.Tensor, counts: torch.Tensor, gelu: str) -> torch.Tensor:
    """M1's forward: ``gelu(h) * [c < n_b]``."""
    rows, n, c, dtype, pc, _ = _check(counts, None, h=h)
    y = torch.empty_like(h)
    rc = _lib().vst_prefix_gelu_fwd(h.data_ptr(), y.data_ptr(), pc, rows, n, c, dtype,
                                    int(gelu == "tanh"), kernels.stream_ptr(h))
    kernels.check_launch(rc, "prefix GELU (M1)")
    GELU_FWD.launches += 1
    return y


def prefix_gelu_bwd_cuda(h: torch.Tensor, g: torch.Tensor, counts: torch.Tensor,
                         gelu: str) -> torch.Tensor:
    """M1's backward: ``gelu'(h) * g * [c < n_b]``."""
    rows, n, c, dtype, pc, _ = _check(counts, None, h=h, g=g)
    dh = torch.empty_like(h)
    rc = _lib().vst_prefix_gelu_bwd(h.data_ptr(), g.data_ptr(), dh.data_ptr(), pc, rows, n, c,
                                    dtype, int(gelu == "tanh"), kernels.stream_ptr(h))
    kernels.check_launch(rc, "prefix GELU backward (M1)")
    GELU_BWD.launches += 1
    return dh


def branch_add_cuda(x: torch.Tensor, f: torch.Tensor, counts: Optional[torch.Tensor],
                    scale: Optional[torch.Tensor]) -> torch.Tensor:
    """M2: ``x + f * s_b * [c < n_b]``."""
    rows, n, c, dtype, pc, ps = _check(counts, scale, x=x, f=f)
    out = torch.empty_like(x)
    rc = _lib().vst_branch_add(x.data_ptr(), f.data_ptr(), out.data_ptr(), pc, ps, rows, n, c,
                               dtype, kernels.stream_ptr(x))
    kernels.check_launch(rc, "branch add (M2)")
    BRANCH_ADD.launches += 1
    return out


def prefix_scale_cuda(g: torch.Tensor, counts: Optional[torch.Tensor],
                      scale: Optional[torch.Tensor]) -> torch.Tensor:
    """M3: ``g * s_b * [c < n_b]``."""
    rows, n, c, dtype, pc, ps = _check(counts, scale, g=g)
    y = torch.empty_like(g)
    rc = _lib().vst_prefix_scale(g.data_ptr(), y.data_ptr(), pc, ps, rows, n, c, dtype,
                                 kernels.stream_ptr(g))
    kernels.check_launch(rc, "prefix scale (M3)")
    SCALE.launches += 1
    return y


class _PrefixGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, counts, gelu):
        ctx.gelu = gelu
        ctx.save_for_backward(h, counts)
        return prefix_gelu_fwd_cuda(h, counts, gelu)

    @staticmethod
    def backward(ctx, g):
        h, counts = ctx.saved_tensors
        return prefix_gelu_bwd_cuda(h, g.contiguous(), counts, ctx.gelu), None, None


class _BranchAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, counts, scale):
        ctx.save_for_backward(counts, scale)
        return branch_add_cuda(x, f, counts, scale)

    @staticmethod
    def backward(ctx, g):
        counts, scale = ctx.saved_tensors
        df = prefix_scale_cuda(g.contiguous(), counts, scale) if ctx.needs_input_grad[1] else None
        return g, df, None, None


class _PrefixScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, counts, scale):
        ctx.save_for_backward(counts, scale)
        return prefix_scale_cuda(g, counts, scale)

    @staticmethod
    def backward(ctx, dy):
        counts, scale = ctx.saved_tensors
        return prefix_scale_cuda(dy.contiguous(), counts, scale), None, None


def prefix_gelu(h: torch.Tensor, counts: torch.Tensor, gelu: str) -> torch.Tensor:
    """``gelu(h) * [c < n_b]``; ``gelu`` is ``"exact"`` (erf) or ``"tanh"``."""
    if gelu not in GELU_FORMS:
        raise ValueError(f"gelu must be one of {tuple(GELU_FORMS)}, got {gelu!r}")
    if h.device.type == "cpu":
        return prefix_gelu_plain(h, counts, gelu)
    return _PrefixGelu.apply(h.contiguous(), counts, gelu)


def branch_add(x: torch.Tensor, f: torch.Tensor, counts: Optional[torch.Tensor],
               scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``x + f * s_b * [c < n_b]``."""
    if x.device.type == "cpu":
        return branch_add_plain(x, f, counts, scale)
    return _BranchAdd.apply(x.contiguous(), f.contiguous(), counts, scale)


def prefix_scale(g: torch.Tensor, counts: Optional[torch.Tensor],
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``g * s_b * [c < n_b]``."""
    if g.device.type == "cpu":
        return prefix_scale_plain(g, counts, scale)
    return _PrefixScale.apply(g.contiguous(), counts, scale)
