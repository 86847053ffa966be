"""The attention lab: other designs of the fused attention's kernels, held
against the model's own and timed beside them.

Port of vit_search_tpu/tools/attn_lab.py::

    python -m vit_search_torch.tools.attn_lab [--variant split]

Four kernels in ``csrc/attn_lab.cu``, each beside its plain version:

- K10 (``_fwd_kernel_T``, attn_lab.py:55): the forward with the context dot
  formed transposed, ``o^T = v^T p^T``. The lab lifts v to p's float32
  (attn_lab.py:65) where K1 rounds p to v's dtype, so in bfloat16 K10 is
  not K1's function: :func:`fwd_T_plain` never rounds p.
- K11 (``_bwd_kernel_T``, attn_lab.py:27): K2's function, the packed
  ``(B, N, 3W)`` cotangent, in one launch.
- K12a (``_dq_kernel``, attn_lab.py:123) and K12b (``_dkv_kernel``,
  attn_lab.py:146): K2's function split into a dq kernel and a dk/dv kernel
  that share nothing, each recomputing s and p. :func:`call_split` returns
  ``cat([dq, dkv])``, K2's packed cotangent, as the lab's ``call_split``
  does.

In bfloat16 all four run on the tensor cores. K10 and K11 are K1's and K2's
one-launch bodies with p and ds kept at float32 precision: each goes into
its products as a bfloat16 hi/lo pair (``hi = bf16(x)``, ``lo = bf16(x -
hi)``), both summed in float32, so they keep the lab's float32 function
(within about 2^-16 of each p and ds, where one bfloat16 operand is 2^-8
off). K12a and K12b are the split bodies that also carry K2 past its
one-launch body's N limit, and round as K2 does (p and ds bfloat16 only as
operands of the products). In float32 all four run on the CUDA cores.

:func:`main` holds K11 against K2 (``bwd_err``) and K10 against K1
(``fwd_err``) at each of :data:`SHAPES`, then times the model's kernels
(``base``) and the lab's (``T``); :func:`main_split` holds the split against
K2 (``err``) and times both. The lab's group size ``g`` and its sweep
(``_pick_group``, attn_lab.py:197, 209, 226-227, 248-265) budget a TPU core's
VMEM per grid cell; the card's kernels run one block per (example, head) at
every shape and have no such knob, so the port's lines leave ``g`` out.

A CPU tensor goes through the plain versions; a CUDA tensor goes through the
kernels, or the wrapper raises. The entry points run on the card unless
given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops import attention as A
from ..ops import kernels
from ..ops.kernels import Kernel

SOURCE = "vit_search_torch/csrc/attn_lab.cu"
LAB = "vit_search_tpu/tools/attn_lab.py"
K10 = kernels.register(Kernel("lab_fwd_t", SOURCE, f"{LAB}:55"))
K11 = kernels.register(Kernel("lab_bwd_t", SOURCE, f"{LAB}:27"))
K12A = kernels.register(Kernel("lab_split_dq", SOURCE, f"{LAB}:123"))
K12B = kernels.register(Kernel("lab_split_dkv", SOURCE, f"{LAB}:146"))

# kernel codes of vst_lab_launch (csrc/attn_lab.cu)
FWD_T, BWD_T, DQ, DKV = 0, 1, 2, 3

# head dims the lab's kernels take: K10, K11 and the float32 K12 are
# instantiated per head dim
LAB_HEAD_DIMS = (8, 16, 32, 48, 64, 128)
ITERS = 30
# (name, B, N, H, D): the supernet's three stage widths at the train batch
SHAPES = [("stage1", 512, 258, 6, 32),
          ("stage2", 512, 66, 12, 48),
          ("stage3", 512, 18, 12, 64)]


# --- plain versions -------------------------------------------------------

def fwd_T_plain(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """K10's function: ``softmax(q k^T * scale) v`` with p kept float32."""
    b, n, w3 = qkv.shape
    o = A._fwd(*A._split(qkv, num_heads), scale, torch.float32)
    return o.reshape(b, n, w3 // 3).to(qkv.dtype)


def bwd_T_plain(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                num_heads: int) -> torch.Tensor:
    """K11's function, which is K2's: the packed ``(B, N, 3W)`` cotangent."""
    return A.attention_qkv_bwd_plain(qkv, do, scale, num_heads)


def _probs(qkv: torch.Tensor, do: torch.Tensor, scale: float, num_heads: int):
    """float32 ``(B, N, H, D)`` q and do and ``(B, H, N, M)`` p and ds."""
    q, k, v = A._split(qkv, num_heads)
    g = do.float().view(q.shape)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", g, v)
    return q, k, g, p, p * (dp - (dp * p).sum(-1, keepdim=True))


def split_dq_plain(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                   num_heads: int) -> torch.Tensor:
    """K12a's function: dq, ``(B, N, W)``."""
    _, k, _, _, ds = _probs(qkv, do, scale, num_heads)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k) * scale
    return dq.reshape(do.shape).to(qkv.dtype)


def split_dkv_plain(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                    num_heads: int) -> torch.Tensor:
    """K12b's function: dk and dv side by side, ``(B, N, 2W)``."""
    q, _, g, p, ds = _probs(qkv, do, scale, num_heads)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, g)
    return torch.cat([dk.reshape(do.shape), dv.reshape(do.shape)], dim=2).to(qkv.dtype)


def split_plain(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                num_heads: int) -> torch.Tensor:
    """The split's result: ``cat([dq, dkv])``, K2's packed cotangent."""
    return torch.cat([split_dq_plain(qkv, do, scale, num_heads),
                      split_dkv_plain(qkv, do, scale, num_heads)], dim=2)


# --- kernels --------------------------------------------------------------

def _lib():
    lib = kernels.library("attn_lab")
    if not getattr(lib, "_vst_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vst_lab_launch.argtypes = [i, p, p, p, i, i, i, i, f, i, p]
        lib.vst_lab_launch.restype = i
        lib.vst_lab_smem_bytes.argtypes = [i, i, i, i]
        lib.vst_lab_smem_bytes.restype = ctypes.c_longlong
        lib._vst_typed = True
    return lib


def _launch(which: int, kernel: Kernel, qkv: torch.Tensor, do: Optional[torch.Tensor],
            parts: int, scale: float, num_heads: int) -> torch.Tensor:
    """Check the operands, launch kernel ``which`` into a new ``(B, N, parts
    * W)`` output and count the launch."""
    kernels.check_cuda_tensor(qkv, "qkv", ndim=3)
    b, n, w3 = qkv.shape
    d = A._head_dim(w3, 3, num_heads)
    if d not in LAB_HEAD_DIMS:
        raise ValueError(f"{kernel.name} takes head_dim in {LAB_HEAD_DIMS}, got {d}")
    if do is not None:
        A._check_like(do, "do", qkv, (b, n, num_heads * d))
    lib = _lib()
    smem = lib.vst_lab_smem_bytes(which, n, d, kernels.DTYPE_CODES[qkv.dtype])
    if smem > A.MAX_SMEM_BYTES:
        raise ValueError(f"{kernel.name} needs {smem} bytes of shared memory at N={n}, "
                         f"d={d}; a block has {A.MAX_SMEM_BYTES}")
    out = torch.empty((b, n, parts * num_heads * d), dtype=qkv.dtype, device=qkv.device)
    rc = lib.vst_lab_launch(which, qkv.data_ptr(), None if do is None else do.data_ptr(),
                            out.data_ptr(), b, n, num_heads, d, scale,
                            kernels.DTYPE_CODES[qkv.dtype], kernels.stream_ptr(qkv))
    kernels.check_launch(rc, kernel.name)
    kernel.launches += 1
    return out


def fwd_T_cuda(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """Launch K10: ``(B, N, 3W) -> (B, N, W)``."""
    return _launch(FWD_T, K10, qkv, None, 1, scale, num_heads)


def bwd_T_cuda(qkv: torch.Tensor, do: torch.Tensor, scale: float,
               num_heads: int) -> torch.Tensor:
    """Launch K11: the packed ``(B, N, 3W)`` cotangent."""
    return _launch(BWD_T, K11, qkv, do, 3, scale, num_heads)


def split_dq_cuda(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                  num_heads: int) -> torch.Tensor:
    """Launch K12a: dq, ``(B, N, W)``."""
    return _launch(DQ, K12A, qkv, do, 1, scale, num_heads)


def split_dkv_cuda(qkv: torch.Tensor, do: torch.Tensor, scale: float,
                   num_heads: int) -> torch.Tensor:
    """Launch K12b: ``(B, N, 2W)``, columns ``[dk | dv]``."""
    return _launch(DKV, K12B, qkv, do, 2, scale, num_heads)


def split_cuda(qkv: torch.Tensor, do: torch.Tensor, scale: float,
               num_heads: int) -> torch.Tensor:
    """Launch K12a, then K12b, on the current stream: ``cat([dq, dkv])``."""
    return torch.cat([split_dq_cuda(qkv, do, scale, num_heads),
                      split_dkv_cuda(qkv, do, scale, num_heads)], dim=2)


# --- the lab's calls, by device -------------------------------------------

FWD = {"base": (A.attention_qkv_fwd_cuda, A.attention_qkv_plain), "T": (fwd_T_cuda, fwd_T_plain)}
BWD = {"base": (A.attention_qkv_bwd_cuda, A.attention_qkv_bwd_plain),
       "T": (bwd_T_cuda, bwd_T_plain)}


def call_fwd(qkv: torch.Tensor, scale: float, num_heads: int, variant: str) -> torch.Tensor:
    """The forward of ``variant``: ``"base"`` (K1) or ``"T"`` (K10)."""
    cuda, plain = FWD[variant]
    return (plain if qkv.device.type == "cpu" else cuda)(qkv, scale, num_heads)


def call_bwd(qkv: torch.Tensor, do: torch.Tensor, scale: float, num_heads: int,
             variant: str) -> torch.Tensor:
    """The packed cotangent by ``variant``: ``"base"`` (K2) or ``"T"`` (K11)."""
    cuda, plain = BWD[variant]
    return (plain if qkv.device.type == "cpu" else cuda)(qkv, do, scale, num_heads)


def call_split(qkv: torch.Tensor, do: torch.Tensor, scale: float,
               num_heads: int) -> torch.Tensor:
    """The packed cotangent by the split (K12a, then K12b)."""
    fn = split_plain if qkv.device.type == "cpu" else split_cuda
    return fn(qkv, do, scale, num_heads)


def time_chained(call: Callable[[], torch.Tensor], device: torch.device,
                 iters: int = ITERS) -> float:
    """ms per call: ``iters`` calls between two CUDA events, the best of three
    after a warm-up call (on the CPU, the host clock around them)."""
    call()
    best = math.inf
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms)
    return best / iters


def inputs(device: torch.device, b: int, n: int, h: int, d: int):
    """Seeded bf16 ``(B, N, 3W)`` qkv and ``(B, N, W)`` do on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn(b, n, 3 * h * d, device=device, generator=gen).to(torch.bfloat16)
    do = torch.randn(b, n, h * d, device=device, generator=gen).to(torch.bfloat16)
    return qkv, do


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _header(device: torch.device) -> str:
    if device.type == "cuda":
        return f"attention lab on {torch.cuda.get_device_name(device)}"
    return "attention lab on the CPU: plain versions, host clock"


def main(shapes: Sequence[Tuple[str, int, int, int, int]] = tuple(SHAPES), iters: int = ITERS,
         device=None) -> List[dict]:
    """The transposed-output study: K11 against K2 and K10 against K1 at each
    shape, then ms per call of each. Returns a record per shape."""
    dev = resolve_device(device)
    print(_header(dev), flush=True)
    records = []
    for name, b, n, h, d in shapes:
        qkv, do = inputs(dev, b, n, h, d)
        scale = d ** -0.5
        base = call_bwd(qkv, do, scale, h, "base")
        bwd_err = _diff(base, call_bwd(qkv, do, scale, h, "T"))
        fbase = call_fwd(qkv, scale, h, "base")
        fwd_err = _diff(fbase, call_fwd(qkv, scale, h, "T"))
        print(f"== {name} B{b} N{n} H{h} D{d} bwd_err={bwd_err:.2e} fwd_err={fwd_err:.2e}",
              flush=True)
        ms = {}
        for tag in ("base", "T"):
            ms[f"bwd {tag}"] = t = time_chained(
                functools.partial(call_bwd, qkv, do, scale, h, tag), dev, iters)
            print(f"  bwd {tag:5s}: {t:7.3f} ms", flush=True)
        for tag in ("base", "T"):
            ms[f"fwd {tag}"] = t = time_chained(
                functools.partial(call_fwd, qkv, scale, h, tag), dev, iters)
            print(f"  fwd {tag:5s}: {t:7.3f} ms", flush=True)
        records.append(dict(name=name, B=b, N=n, H=h, D=d, bwd_err=bwd_err, fwd_err=fwd_err,
                            bwd_ref_max=float(base.float().abs().max()),
                            fwd_ref_max=float(fbase.float().abs().max()), ms=ms))
    return records


def main_split(shapes: Sequence[Tuple[str, int, int, int, int]] = tuple(SHAPES),
               iters: int = ITERS, device=None) -> List[dict]:
    """The dq / dk-dv split study: the split against K2 at each shape, then
    ms per call of each. Returns a record per shape."""
    dev = resolve_device(device)
    print(_header(dev), flush=True)
    records = []
    for name, b, n, h, d in shapes:
        qkv, do = inputs(dev, b, n, h, d)
        scale = d ** -0.5
        base = call_bwd(qkv, do, scale, h, "base")
        err = _diff(base, call_split(qkv, do, scale, h))
        print(f"== {name} B{b} N{n} H{h} D{d} err={err:.2e}", flush=True)
        ms = {"base": time_chained(functools.partial(call_bwd, qkv, do, scale, h, "base"),
                                   dev, iters),
              "split": time_chained(functools.partial(call_split, qkv, do, scale, h),
                                    dev, iters)}
        for tag, t in ms.items():
            print(f"  {tag:6s} : {t:7.3f} ms", flush=True)
        records.append(dict(name=name, B=b, N=n, H=h, D=d, err=err,
                            ref_max=float(base.float().abs().max()), ms=ms))
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", choices=("T", "split"), default="T",
                        help="T: the transposed-output kernels (K10, K11); split: K12a + K12b")
    args = parser.parse_args()
    if args.variant == "split":
        main_split()
    else:
        main()
