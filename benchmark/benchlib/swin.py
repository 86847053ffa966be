"""What the SwinV2 cell needs beside the ViT-ResNAS cells' library: its
weights and draws from the seed, its cost model, the work of the windowed
attention kernel, and the reading of the program's ``vst.swin.*`` spans.

Weights: ``draws.make_weights``'s, then the leaves a mid-run SwinV2 holds
away from that rule: ``logit_scale`` near ln 10 (its init, so a scale near
10), the bias MLP at its fan-in scale (so the position bias spreads over
its range instead of sitting at 8). Draws of a checked step: the train
cells' erasing boxes and fill and stochastic-depth keeps
(``draws.make_step_draws``), and one batch-mode Mixup/CutMix draw from a
stream of its own.

The cost model is Swin's ``flops()`` (21.8 G multiply-adds at 256 px),
written here from the published configuration, independent of the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import device, draws as D

MIX = 11
LOGIT_SCALE = math.log(10.0)
LOGIT_SCALE_STD = 0.1
WINDOW_SPANS = ("vst.swin.window", "vst.swin.bias")
NOT_KERNELS = ("Memcpy", "Memset")


def make_weights(shapes: Dict[str, Sequence[int]], seed: int, dev) -> Dict[str, torch.Tensor]:
    out = D.make_weights(shapes, seed, dev)
    for name, t in out.items():
        if name.endswith("logit_scale"):
            t.mul_(LOGIT_SCALE_STD / D.INIT_STD).add_(LOGIT_SCALE)
        elif ".cpb_mlp." in name and name.endswith("weight"):
            t.mul_(float(shapes[name][-1]) ** -0.5 / D.INIT_STD)
    return out


@dataclasses.dataclass
class MixDraw:
    """One batch-mode Mixup/CutMix draw: CutMix where ``use_cutmix`` (the
    partner's box ``[y0, y1) x [x0, x1)`` pasted), else a blend by
    ``lam0``; the partner of image ``i`` is image ``B - 1 - i``."""

    lam0: float
    use_cutmix: bool
    y0: int
    y1: int
    x0: int
    x1: int

    def lam(self, size: int) -> float:
        """The targets' weight: ``lam0``, or the share the box leaves."""
        if not self.use_cutmix:
            return float(np.float32(self.lam0))
        area = np.float32((self.y1 - self.y0) * (self.x1 - self.x0))
        return float(np.float32(1.0) - area / np.float32(size * size))


def mix_draw(seed: int, index: int, size: int, mixup: float, cutmix: float,
             switch_prob: float) -> MixDraw:
    """timm's batch-mode draw: CutMix with probability ``switch_prob`` (lam
    from Beta(cutmix, cutmix)), else mixup (Beta(mixup, mixup)); the box
    covers ``1 - lam`` of the image around a uniform centre, clipped."""
    rng = D.host_generator(seed, MIX, index)
    use_cutmix = bool(rng.random() < switch_prob)
    lam0 = float(np.float32(rng.beta(cutmix, cutmix) if use_cutmix else rng.beta(mixup, mixup)))
    cut = int(size * math.sqrt(1.0 - lam0))
    cy, cx = int(rng.integers(0, size)), int(rng.integers(0, size))
    y0, y1 = int(np.clip(cy - cut // 2, 0, size)), int(np.clip(cy + cut // 2, 0, size))
    x0, x1 = int(np.clip(cx - cut // 2, 0, size)), int(np.clip(cx + cut // 2, 0, size))
    return MixDraw(lam0, use_cutmix, y0, y1, x0, x1)


# --- cost ----------------------------------------------------------------------

def macs(cfg: Dict, img_size: Optional[int] = None) -> int:
    """Multiply-adds of one image, as Swin's ``flops()`` counts them."""
    patch, embed, depths = cfg["patch_size"], cfg["embed_dim"], cfg["depths"]
    r0 = r = (img_size or cfg["img_size"]) // patch
    total = r * r * embed * 3 * patch * patch + r * r * embed
    for i, depth in enumerate(depths):
        dim = embed * 2 ** i
        ws = min(cfg["window_size"], r)
        n, nw = ws * ws, (r // ws) ** 2
        attn = n * dim * 3 * dim + 2 * n * n * dim + n * dim * dim
        total += depth * (2 * r * r * dim + nw * attn + int(2 * r * r * dim * dim * cfg["mlp_ratio"]))
        if i < len(depths) - 1:
            total += (r // 2) * (r // 2) * 4 * dim * 2 * dim + r * r * dim // 2
            r //= 2
    features = embed * 2 ** (len(depths) - 1)
    return total + features * r0 * r0 // 2 ** len(depths) + features * cfg["num_classes"]


def window_calls(cfg: Dict, batch: int) -> List[Tuple[Tuple[int, int, int, int], int]]:
    """``((windows, N, heads, shift), calls a step)`` of the windowed
    attention: every second block of a stage wider than its window shifted
    by half a window."""
    out: Dict[Tuple[int, int, int, int], int] = {}
    r = cfg["img_size"] // cfg["patch_size"]
    for i, depth in enumerate(cfg["depths"]):
        ws = min(cfg["window_size"], r)
        for b in range(depth):
            shift = ws // 2 if r > ws and b % 2 == 1 else 0
            key = (batch * (r // ws) ** 2, ws * ws, cfg["num_heads"][i], shift)
            out[key] = out.get(key, 0) + 1
        r //= 2
    return sorted(out.items(), key=lambda kv: (-kv[0][1], -kv[0][0], kv[0][3]))


def window_bytes(bw: int, n: int, h: int, d: int, backward: bool) -> float:
    """The attention's bf16 traffic (``device.attention_bytes``), plus the
    f32 bias read once and, backward, its f32 gradient written once."""
    table = 4.0 * h * n * n
    return device.attention_bytes(bw, n, h, d, backward) + table * (2 if backward else 1)


def window_share(calls, seed: int, head_dim: int, batch: int) -> Optional[float]:
    """The windowed attention's forward and backward (fold included) at
    ``calls`` (:func:`window_calls` of ``batch`` images) as a share of its
    roofline, in %: each shape through the op's public entry, its device
    time from ``device.kernel_seconds``, both sums weighted by calls."""
    from vit_search_torch.models.swin_v2 import shift_regions
    from vit_search_torch.ops.window_attention import window_attention

    gen = torch.Generator(device="cuda").manual_seed(seed % 2**63)
    bound = measured = 0.0
    for (bw, n, h, shift), count in calls:
        ws = math.isqrt(n)
        ids = shift_regions(ws * math.isqrt(bw // batch), ws, shift).cuda() if shift else None

        def make():
            qkv = torch.randn(bw, n, 3 * h * head_dim, device="cuda", generator=gen).bfloat16()
            scale = torch.full((h,), 10.0, device="cuda").requires_grad_()
            bias = (16 * torch.rand(h, n, n, device="cuda", generator=gen)).requires_grad_()
            g = torch.randn(bw, n, h * head_dim, device="cuda", generator=gen).bfloat16()
            return qkv.requires_grad_(), scale, bias, g

        def call(qkv, scale, bias, g):
            out = window_attention(qkv, scale, bias, ids, h)
            torch.autograd.grad(out, (qkv, scale, bias), g)

        seconds = device.kernel_seconds(call, make, 10)
        if seconds is None:
            return None
        measured += seconds * count
        bound += count * (device.bound_s(window_bytes(bw, n, h, head_dim, False),
                                         device.attention_fwd_flops(bw, n, h, head_dim))
                          + device.bound_s(window_bytes(bw, n, h, head_dim, True),
                                           device.attention_bwd_flops(bw, n, h, head_dim)))
    return device.share_pct(bound, measured)


# --- spans -------------------------------------------------------------------------

def span_share(events, names: Sequence[str] = WINDOW_SPANS) -> Optional[float]:
    """The share, in %, of the device's kernel time in a profiled window
    that went to kernels launched inside a span of ``names``: each host
    operation that starts inside such a span on the span's thread brings
    the kernels the profiler links to it. ``None`` where the trace holds no
    such span (a program without them) or no kernel."""
    from torch.autograd import DeviceType

    spans: Dict[int, List[Tuple[float, float]]] = {}
    ops, total = [], 0.0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and not e.name.startswith(NOT_KERNELS):
                total += e.time_range.end - e.time_range.start
        elif e.name in names:
            spans.setdefault(e.thread, []).append((e.time_range.start, e.time_range.end))
        elif e.kernels:
            ops.append(e)
    if not spans or total <= 0:
        return None
    inside = 0.0
    for e in ops:
        start = e.time_range.start
        if any(a <= start < b for a, b in spans.get(e.thread, ())):
            inside += sum(k.duration for k in e.kernels if not k.name.startswith(NOT_KERNELS))
    return 100.0 * inside / total
