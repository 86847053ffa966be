"""Time the masked-LN kernels K3 and K4 of one checkout of the port, launch by launch.

    python vit_search_torch/tools/ln_check.py [--root DIR]

imports the port from the checkout at ``DIR`` (by default the one this file
lies in), so one copy of this file times a parent's kernels and a change's
side by side on one card. It prints one JSON line: the card, and at the
three stage shapes of the 224 px supernet (seeded bf16 inputs, a mask per
example) K3 at B = 512 and 2048 and K4 at B = 512, each with its device ms
per call (launches captured in one CUDA graph over copies of the inputs that
together exceed twice the 50 MB L2, so each call reads from device memory)
and the device µs of each of its launches by kernel name (``torch.profiler``
over ten calls). Beside K3, ``copy_ms``: ``Tensor.copy_`` of x into a fresh
tensor, the same bytes read and written as K3's x and y, timed the same way:
what a plain stream of those bytes takes on this card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# (N, C) of the supernet's three stages at 224 px
STAGES = ((257, 256), (65, 512), (17, 1024))
CALLS = 10


def _launch_us(fn, args: tuple) -> dict:
    """Device µs per call of each kernel ``fn(*args)`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.search(r"\w+kernel\w*(<[^>]*>)?", e.key)
            out[name.group(0) if name else e.key[:80]] = e.self_device_time_total / CALLS
    return out


def main(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from vit_search_torch.ops import masked_layer_norm as M
    from vit_search_torch.ops.masking import make_channel_mask
    from vit_search_torch.tools.attn_check import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("ln_check: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    out = {"card": card, "root": os.path.abspath(root), "kernels": []}
    for stage, (n, c) in enumerate(STAGES, 1):
        for b in (512, 2048):
            gen = torch.Generator(device="cuda").manual_seed(c)
            counts = torch.as_tensor(np.random.default_rng(c).integers(c // 2, c + 1, b),
                                     device="cuda")
            mask = make_channel_mask(counts, c, dtype=torch.bfloat16)
            x = torch.randn(b, n, c, device="cuda", generator=gen).to(torch.bfloat16) * mask
            w = torch.randn(c, device="cuda", generator=gen)
            fwd = (x, mask, w, w, 1e-6)
            out["kernels"].append({"kernel": "K3", "stage": stage, "B": b,
                                   "ms": graph_ms(M.masked_ln_fwd_cuda, fwd),
                                   "launch_us": _launch_us(M.masked_ln_fwd_cuda, fwd),
                                   "copy_ms": graph_ms(torch.Tensor.copy_,
                                                       (torch.empty_like(x), x))})
            if b == 512:
                g = torch.randn(b, n, c, device="cuda", generator=gen).to(torch.bfloat16)
                bwd = (x, mask, w, M.masked_ln_fwd_cuda(*fwd)[1], g)
                out["kernels"].append({"kernel": "K4", "stage": stage, "B": b,
                                       "ms": graph_ms(M.masked_ln_bwd_cuda, bwd),
                                       "launch_us": _launch_us(M.masked_ln_bwd_cuda, bwd)})
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.join(os.path.dirname(__file__), "..", ".."),
                        help="checkout whose vit_search_torch is timed")
    print(json.dumps(main(parser.parse_args().root)))
