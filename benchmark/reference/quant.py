"""The control's lower precision: float8 (e4m3) operands.

The configurations state bfloat16 compute; the nearest precision below it is
float8. ``fp8`` rounds a product's operand to float8 e4m3 with one scale per
tensor (its largest magnitude onto e4m3's largest finite value, 448), as a
float8 matrix multiply takes it, and hands it back in float32 for the
product itself.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x.detach())


def int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with one scale per tensor: its largest magnitude onto
    127."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 127.0
    rounded = torch.round(x.detach() / scale).clamp(-127, 127) * scale
    return x + (rounded - x.detach())


QUANTS = {"fp8": fp8, "int8": int8}
