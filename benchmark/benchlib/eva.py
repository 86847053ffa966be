"""What the EVA-02 cell needs beside the train cells' library: its cost
model, the calls of its two fused layers a step, and the work each of them
must do, held to a roofline.

The cost model counts EVA-02-L's multiply-adds from the published
configuration, independent of the program: the patch projection, per block
the q/k/v, projection and three MLP linears and the two attention products
over all N tokens, and the head (361.7 G at 448 px).

The work of the rotary attention (``rope_attention_*``): forward the two
products (``q k^T``, ``p v``) of every (example, head), 4 B H N^2 d
operations, and the rotation of q and k (3 operations an element of each);
backward the five products (the scores again, dV, dP, dQ, dK), 10 B H N^2
d, and the rotations again with their transposes on dq and dk. Bytes:
forward the packed projection in, the output and the float32 log-sum-exp
out, the float32 tables in; backward the projection, the output, its
cotangent, the log-sum-exp and the tables in, the packed cotangent out. The
SwiGLU sub-LN (``swiglu_ln_*``) is held to HBM alone: forward the packed
``(rows, 2H)`` GEMM output in, the normalised ``(rows, H)`` out, each row's
float32 mean and ``1 / std`` out, the float32 weight and bias in; backward
the GEMM output, the cotangent, the statistics and the weight in, the
packed cotangent and the float32 weight and bias gradients out.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import device

Shape = Tuple[int, ...]


def _dims(cfg: Dict, img_size: Optional[int] = None):
    size = img_size or cfg["img_size"]
    grid = size // cfg["patch_size"]
    return grid * grid, 1 + grid * grid, cfg["embed_dim"], int(cfg["embed_dim"] * cfg["mlp_ratio"])


def macs(cfg: Dict, img_size: Optional[int] = None) -> int:
    """Multiply-adds of one image's forward."""
    patches, n, c, hidden = _dims(cfg, img_size)
    block = 3 * n * c * c + 2 * n * n * c + n * c * c + 2 * n * c * hidden + n * hidden * c
    p = cfg["patch_size"]
    return patches * c * 3 * p * p + cfg["depth"] * block + c * cfg["num_classes"]


def parameters(cfg: Dict) -> int:
    """The model's parameters, counted from the published configuration."""
    patches, n, c, hidden = _dims(cfg)
    p = cfg["patch_size"]
    block = (2 * c + 3 * c * c + 2 * c + 2 * c + c * c + c + 2 * c
             + 2 * (hidden * c + hidden) + 2 * hidden + c * hidden + c)
    return (c * 3 * p * p + c + c + n * c + cfg["depth"] * block + 2 * c
            + c * cfg["num_classes"] + cfg["num_classes"])


def rope_shape(cfg: Dict, batch: int) -> Shape:
    """``(B, N, heads, d)`` of the rotary attention's calls."""
    _, n, c, _ = _dims(cfg)
    return (batch, n, cfg["num_heads"], c // cfg["num_heads"])


def swiglu_shape(cfg: Dict, batch: int, pad: int = 0) -> Shape:
    """``(rows, H, P)`` of the SwiGLU sub-LN's calls: ``P = H + pad`` is the
    row pitch that the program's GEMM output has (the roofline counts the
    work of ``H``)."""
    _, n, _, hidden = _dims(cfg)
    return (batch * n, hidden, hidden + pad)


def rope_flops(b: int, n: int, h: int, d: int, backward: bool) -> float:
    w = h * d
    if backward:
        return device.attention_bwd_flops(b, n, h, d) + 12.0 * b * n * w
    return device.attention_fwd_flops(b, n, h, d) + 6.0 * b * n * w


def rope_bytes(b: int, n: int, h: int, d: int, backward: bool) -> float:
    w = h * d
    lse, tables = 4.0 * b * h * n, 2 * 4.0 * n * d
    if backward:
        return 2.0 * b * n * (3 * w + w + w + 3 * w) + lse + tables
    return 2.0 * b * n * (3 * w + w) + lse + tables


def swiglu_bytes(rows: int, hidden: int, backward: bool) -> float:
    if backward:
        return 2.0 * rows * (2 * hidden + hidden + 2 * hidden) + 8.0 * rows + 4.0 * hidden \
            + 8.0 * hidden
    return 2.0 * rows * (2 * hidden + hidden) + 8.0 * rows + 8.0 * hidden


def rope_share(calls: List[Tuple[Shape, float]], seed: int) -> Optional[float]:
    """The rotary attention's forward and backward at ``calls`` (``((B, N,
    heads, d), calls a step)``) as a share of their roofline, in %: each
    shape through the op's public entry with EVA-02's tables, its device
    time from ``device.kernel_seconds``, both sums weighted by calls.
    ``None`` for a program without the op."""
    import torch
    try:
        from vit_search_torch.models.eva02 import rope_tables
        from vit_search_torch.ops.rope_attention import rope_attention
    except ImportError:
        return None

    gen = torch.Generator(device="cuda").manual_seed(seed % 2**63)
    bound = measured = 0.0
    for (b, n, h, d), count in calls:
        grid = int(round((n - 1) ** 0.5))
        tables = tuple(t.cuda() for t in rope_tables(grid, d))

        def make():
            qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).bfloat16()
            g = torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16()
            return qkv.requires_grad_(), g

        def call(qkv, g):
            out = rope_attention(qkv, tables, d ** -0.5, h)
            torch.autograd.grad(out, qkv, g)

        seconds = device.kernel_seconds(call, make, 10)
        if seconds is None:
            return None
        measured += seconds * count
        bound += count * (device.bound_s(rope_bytes(b, n, h, d, False),
                                         rope_flops(b, n, h, d, False))
                          + device.bound_s(rope_bytes(b, n, h, d, True),
                                           rope_flops(b, n, h, d, True)))
    return device.share_pct(bound, measured)


def swiglu_share(calls: List[Tuple[Shape, float]], seed: int) -> Optional[float]:
    """The SwiGLU sub-LN's forward and backward (the fold included) at
    ``calls`` (``((rows, H, P), calls a step)``, the packed input at pitch
    ``P``, as the program launches it) as a share of their HBM bound,
    in %, measured as :func:`rope_share` measures. ``None`` for a program
    without the op."""
    import torch
    try:
        from vit_search_torch.ops.swiglu_ln import swiglu_ln
    except ImportError:
        return None

    gen = torch.Generator(device="cuda").manual_seed(seed % 2**63)
    bound = measured = 0.0
    for (rows, hidden, pitch), count in calls:
        def make():
            u = (2 * torch.randn(rows, 2 * pitch, device="cuda", generator=gen)).bfloat16()
            g = torch.randn(rows, pitch, device="cuda", generator=gen).bfloat16()
            w = 1 + 0.1 * torch.randn(hidden, device="cuda", generator=gen)
            beta = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
            return u.requires_grad_(), w.requires_grad_(), beta.requires_grad_(), g

        def call(u, w, beta, g):
            y = swiglu_ln(u, w, beta, 1e-6)
            torch.autograd.grad(y, (u, w, beta), g)

        seconds = device.kernel_seconds(call, make, 10)
        if seconds is None:
            return None
        measured += seconds * count
        bound += count * (device.bound_s(swiglu_bytes(rows, hidden, False), 0.0)
                          + device.bound_s(swiglu_bytes(rows, hidden, True), 0.0))
    return device.share_pct(bound, measured)
