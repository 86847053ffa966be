"""Time the RegNetY-16GF teacher's forward on the card, and two alternatives.

    python -m vit_search_torch.tools.teacher_check [--batch 512]

prints one JSON line: the device ms of ``regnety_160_upsample``'s eval
forward on a bf16 224 px batch (median of five, CUDA events, after two
warm-up calls) as the port builds it (channels-last convolutions, flax's
batch norm in plain float32 ops), with the convolutions in NCHW instead, and
with each eval batch norm as one ``F.batch_norm`` call; each with its
largest kernels from ``torch.profiler``. The alternatives change rounding
only (the same function), and are measured here, not used by the port.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from typing import Callable

import torch
import torch.nn.functional as F

from ..models import create_model
from ..models.patch_embed import BatchNorm


def median_ms(fn: Callable[[], object], reps: int = 5) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def top_kernels(fn: Callable[[], object], top: int = 8):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key[:100], e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])[:top]


def fused_eval_bn(self: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Eval batch norm as one ``F.batch_norm`` call on the float32 input."""
    return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                        self.bias, False, 0.0, self.eps).to(x.dtype)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=512)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    model = create_model("regnety_160_upsample", dtype=torch.bfloat16, seed=0).eval()
    x = torch.randn(args.batch, 224, 224, 3, device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": card, "batch": args.batch, "variants": {}}

    def measure(name: str, images: torch.Tensor) -> None:
        with torch.no_grad():
            out["variants"][name] = {"ms": median_ms(lambda: model(images)),
                                     "top_kernels": top_kernels(lambda: model(images))}

    measure("channels_last (as built)", x)
    model.to(memory_format=torch.contiguous_format)
    # the same NHWC values, stored so that the model's NCHW view is contiguous
    measure("nchw", x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    model.to(memory_format=torch.channels_last)
    forward = BatchNorm.forward
    BatchNorm.forward = fused_eval_bn
    try:
        measure("channels_last, F.batch_norm", x)
    finally:
        BatchNorm.forward = forward
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
