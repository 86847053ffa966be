"""Fingerprint and time the attention kernels of one checkout of the port.

    python -m vit_search_torch.tools.attn_check

run from the root of a checkout, prints one JSON line: a sha256 of K1's
output and of K2's packed cotangent at the three stage shapes of the 224 px
supernet (B = 512 and 2048, seeded bf16 inputs), and the device ms per
launch of K1, K2, K7, K9, K10, K11 and the split pair K12a + K12b there at
B = 512. Run it in two checkouts (a parent and a change), one after the
other on one card: equal hashes mean the kernels give the same bits, and the
times compare the two builds side by side. Times are device time per launch:
launches captured in one CUDA graph over copies of the inputs that together
exceed twice the 50 MB L2, so each launch reads from device memory.
"""

from __future__ import annotations

import hashlib
import json
import math

import torch

from ..device import resolve_device
from ..ops import attention as A
from . import attn_lab as L

# (N, heads, head_dim) of the supernet's three stages at 224 px
STAGES = ((257, 6, 32), (65, 12, 48), (17, 12, 64))
L2_BYTES = 50 * 2**20


def graph_ms(fn, args: tuple, reps: int = 20) -> float:
    """Device ms per launch of ``fn(*args)`` (see the module docstring)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    size = sum(t.numel() * t.element_size() for t in tensors)
    copies = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                       for _ in range(math.ceil(2 * L2_BYTES / size))]
    reps = max(reps, len(copies))
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fn(*copies[i % len(copies)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()


def main() -> dict:
    dev = resolve_device(None)
    record = {"card": torch.cuda.get_device_name(dev), "bits": {}, "ms": {}}
    for n, h, d in STAGES:
        scale = d ** -0.5
        for b in (512, 2048):
            gen = torch.Generator(device=dev).manual_seed(n + b)
            qkv = torch.randn(b, n, 3 * h * d, device=dev, generator=gen).to(torch.bfloat16)
            do = torch.randn(b, n, h * d, device=dev, generator=gen).to(torch.bfloat16)
            record["bits"][f"K1 B{b} N{n}"] = _sha(A.attention_qkv_fwd_cuda(qkv, scale, h))
            record["bits"][f"K2 B{b} N{n}"] = _sha(A.attention_qkv_bwd_cuda(qkv, do, scale, h))
            if b != 512:
                continue
            q, k, v = (t.contiguous() for t in qkv.split(h * d, dim=2))
            qkv_t, do_t = qkv.transpose(0, 1).contiguous(), do.transpose(0, 1).contiguous()
            for name, fn, args in (
                    ("K1", A.attention_qkv_fwd_cuda, (qkv, scale, h)),
                    ("K2", A.attention_qkv_bwd_cuda, (qkv, do, scale, h)),
                    ("K7", A.attention_bwd_cuda, (q, k, v, do, scale, h)),
                    ("K9", A.attention_qkv_t_bwd_cuda, (qkv_t, do_t, scale, h)),
                    ("K10", L.fwd_T_cuda, (qkv, scale, h)),
                    ("K11", L.bwd_T_cuda, (qkv, do, scale, h)),
                    ("K12 pair", L.split_cuda, (qkv, do, scale, h))):
                record["ms"][f"{name} N{n}"] = graph_ms(fn, args)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
