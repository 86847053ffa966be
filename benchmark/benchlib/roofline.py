"""A kernel's share of its roofline at the shapes a cell runs.

Each shape is called through the op's public entry in the port; its device
time is the sum of the durations of the operations a call launches
(``device.kernel_seconds``: a ``torch.profiler`` trace over inputs rotated
past the L2). Its bound is the larger of its operations over the bf16 peak
and its bytes over HBM bandwidth, from the shapes alone. The share is the
sum of the bounds over the sum of the times, both weighted by calls per
step or forward; ``None`` where the card gives no device time.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from . import device

REPS = 20


def attention_share(calls: Sequence, seed: int, backward: bool) -> Optional[float]:
    """``calls``: ``((B, N, H, D), calls)``; the forward of
    ``fused_attention_qkv`` (bf16, packed q|k|v), and its backward where
    ``backward``."""
    import torch
    from vit_search_torch.ops.attention import fused_attention_qkv

    gen = torch.Generator(device="cuda").manual_seed(seed % 2**63)
    bound = measured = 0.0
    for (b, n, h, d), count in calls:
        def make():
            qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).bfloat16()
            g = torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16()
            return qkv.requires_grad_(backward), g

        def call(qkv, g):
            with torch.set_grad_enabled(backward):
                out = fused_attention_qkv(qkv, d ** -0.5, h)
            if backward:
                torch.autograd.grad(out, qkv, g)

        seconds = device.kernel_seconds(call, make, REPS)
        if seconds is None:
            return None
        measured += seconds * count
        bound += count * device.bound_s(device.attention_bytes(b, n, h, d, False),
                                        device.attention_fwd_flops(b, n, h, d))
        if backward:
            bound += count * device.bound_s(device.attention_bytes(b, n, h, d, True),
                                            device.attention_bwd_flops(b, n, h, d))
    return device.share_pct(bound, measured)


def masked_ln_share(calls: Sequence, seed: int, arch_of_row: Callable[[int], int],
                    backward: bool) -> Optional[float]:
    """``calls``: ``((B, N, C), embed keep widths, calls)``; the fused route
    of ``masked_layer_norm`` (bf16), its backward where ``backward``. Row
    ``b`` belongs to architecture ``arch_of_row(b)``, which keeps the
    ``widths`` entry of that index (cycled)."""
    import torch
    from vit_search_torch.ops.masked_layer_norm import masked_layer_norm

    gen = torch.Generator(device="cuda").manual_seed(seed % 2**63)
    bound = measured = 0.0
    for (b, n, c), widths, count in calls:
        keep = torch.tensor([widths[arch_of_row(i) % len(widths)] for i in range(b)],
                            device="cuda")
        mask = (torch.arange(c, device="cuda").view(1, 1, -1) < keep.view(-1, 1, 1)).bfloat16()

        def make():
            x = torch.randn(b, n, c, device="cuda", generator=gen).bfloat16() * mask
            w = torch.randn(c, device="cuda", generator=gen)
            bias = torch.randn(c, device="cuda", generator=gen)
            g = torch.randn(b, n, c, device="cuda", generator=gen).bfloat16()
            return (x.requires_grad_(backward), w.requires_grad_(backward),
                    bias.requires_grad_(backward), g)

        def call(x, w, bias, g):
            with torch.set_grad_enabled(backward):
                y = masked_layer_norm(x, w, bias, mask, 1e-6, "fused")
            if backward:
                torch.autograd.grad(y, (x, w, bias), g)

        seconds = device.kernel_seconds(call, make, REPS)
        if seconds is None:
            return None
        measured += seconds * count
        bound += count * device.bound_s(device.masked_ln_bytes(b, n, c, False), 0.0)
        if backward:
            bound += count * device.bound_s(device.masked_ln_bytes(b, n, c, True), 0.0)
    return device.share_pct(bound, measured)
