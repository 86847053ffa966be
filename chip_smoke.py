#!/usr/bin/env python3
"""Time the port's hand-written kernels on one CUDA card (an H100), and run
the 24 published recipes through the port's CLIs there.

    python3 chip_smoke.py [--out DIR] [--phase all|swin|stem]

Two jobs, each fatal on failure (non-zero exit, no result line):

1. The kernel table. After the card's name and power limit (``nvidia-smi``)
   and the build (``nvcc``, sm_90a; K3/K4's registers and spills from the
   ptxas report, on stderr), each case of ``cases()`` compares its kernels
   with their plain PyTorch versions at the case's shape (``compare``, within
   the tolerance the row states: a timed kernel is a correct one) and times
   them. ``--phase stem``, ``--phase swin`` and ``--phase prefix`` run only
   those groups of cases. Each row of the ``{"kernels": [...]}`` line has the columns:

   - ``name``, ``source``, ``replaces``: the kernel's record, its source file
     and the TPU kernel it ports;
   - ``stage``, ``batch``, ``shape``: the case's label and shape;
   - ``net``, ``launches``: the net whose pass gives the shape (a script of
     ``RECIPE_DIR``, DeiT-S or SwinV2-B; none for the op-level API's K6-K9
     and the lab's K10-K12, which no model launches) and, for a script, the
     kernel's launches as the recipes phase of this process counted them in
     that script's run, with the run's train steps and eval or scoring
     forwards (``{"count", "steps", "forwards"}``, held there to
     ``recipe_launches``; K5 counts 0, since no script takes
     ``ln_route="stats"``); null where nothing in the process counted them:
     DeiT-S, SwinV2-B, no net, and every ``--phase`` run but ``all``;
   - ``max_abs_err``, ``tolerance``: against the plain version;
   - ``ms``: device time per launch (launches captured in a CUDA graph,
     inputs rotated past the L2 cache); ``call_ms``: per call of the
     wrapper, host overhead included;
   - ``bound_ms``, ``bound_by``: max(bytes / HBM bandwidth, operations /
     peak rate) from the H100's data sheet;
   - ``plain_ms``: the plain version; ``library_ms``: PyTorch's own call for
     the same work (``library_call``: SDPA, ``F.layer_norm``, cuDNN's batch
     norm), a yardstick only.

   The inputs are bf16, so K1/K2 and K6-K9 run their tensor-core bodies,
   which round p and ds to bf16 as MMA operands where the plain versions
   keep them f32: they agree within ``BF16_TOL``, not bit for bit. The lab's
   K10 and K11 keep p and ds as bf16 hi/lo pairs: their mean error against
   the f32 function must be below K1's and K2's, and each lab row carries
   ``err_vs_base``, its error against K1's or K2's plain function. Last of
   all, K4's two launches (the rows, then the fold of the per-block
   partials) are timed apart by ``torch.profiler``.
2. The recipes: the 24 published scripts of ``scripts/vit-sr-nas`` through
   ``cli.train.main`` and ``cli.evo_search.main`` in this process, each with
   its own arguments (``recipe_argv``: only the data, a view of a synthetic
   1000-class folder made beside the kernel table whose train and val are
   its sub-train and sub-val; one epoch of 2 steps; the loader workers; each
   search's population, 8 + 8 candidates, and its MODEL_PATH, the checkpoint
   its supernet's one-epoch run wrote), at each script's own batch, with the
   working directory at a temporary root so that every relative
   ``models/...`` path resolves as the scripts write it: every loss finite,
   every acc1 in [0, 100], every candidate in its MAC band, the checkpoints
   later scripts read present, every kernel's launches exact per train step
   and per eval or scoring forward (``recipe_launches``), peak memory under
   the card's, one line per script on stderr. Then K1/K2 (and K3/K4 on the
   supernets) at every stage of ``RECIPE_KERNEL_SCRIPTS``' nets at their
   scripts' batches, as rows of the table with K2's route by kernel name
   (profiled right after the build, the process's first profiler session),
   and one profiled step of the Small supernet from device batches.

The last line is ``{"ok": true, "device": {...}}``; ``--out`` gets the full
report. The card's other checks are the gpu-marked tests (``python -m pytest
--noconftest -m gpu tests/test_torch_gpu*.py tests/test_torch_prefix_mask.py``);
end-to-end rates are the benchmark's (``python3 benchmark/run.py``).

It imports nothing of JAX. It exits non-zero when no CUDA device is
available, and when it stands alone without the repository.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

BATCH = 512               # the table's train batch: the Tiny supernet script's 1024 halved
EXAMPLE_PER_ARCH = 32
SEARCH_BATCH = 2048       # images per scoring forward: --arch-batch 8 x --val-bs 256
REPS = 10                 # timed launches per kernel
# attention kernels (forward, backward) by layout
ATTENTION_KERNELS = {"packed": ("attention_qkv_fwd", "attention_qkv_bwd"),
                     "separate": ("attention_fwd", "attention_bwd"),
                     "seq_major": ("attention_qkv_t_fwd", "attention_qkv_t_bwd")}
KERNEL_NAMES = ("attention_qkv_fwd", "attention_qkv_bwd", "masked_layer_norm_fwd",
                "masked_layer_norm_bwd", "row_sum_sumsq", "attention_fwd", "attention_bwd",
                "attention_qkv_t_fwd", "attention_qkv_t_bwd", "lab_fwd_t", "lab_bwd_t",
                "lab_split_dq", "lab_split_dkv", "layer_norm_fwd", "layer_norm_bwd",
                "window_attention_fwd", "window_attention_bwd", "batch_norm_stats",
                "batch_norm_apply", "batch_norm_bwd", "prefix_gelu_fwd", "prefix_gelu_bwd",
                "branch_add", "prefix_scale")
# SwinV2-B's windowed attention at 256 px, 256 images: (windows B * nW, N,
# heads, shift, the stage's resolution), each stage's unshifted and shifted
# blocks (stages 3 and 4 are one window and never shift)
SWIN_STAGES = ((4096, 256, 4, 0, 64), (4096, 256, 4, 8, 64), (1024, 256, 8, 0, 32),
               (1024, 256, 8, 8, 32), (256, 256, 16, 0, 16), (256, 64, 32, 0, 8))


def per_pass(**counts):
    """Launches of every kernel per pass of a net, 0 unless given."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


# the Conv-BN-ReLU layers of a conv stem (network_def types 4/5)
STEM_NORMS = 3


def with_stem(per: dict, norms: int, train: bool) -> dict:
    """``per`` with the batch norms of a stem of ``norms`` of them: B1's
    statistics and normalize and B2 a train step, B1's normalize alone an
    eval or scoring forward."""
    return dict(per, batch_norm_stats=norms if train else 0, batch_norm_apply=norms,
                batch_norm_bwd=norms if train else 0)


# the scripts whose nets give the table's shapes (``recipe_stages``)
TINY, TINY_SEARCH = "super_net/tiny.sh", "evolutionary_search/tiny.sh"
SEARCHED, MEDIUM = "searched_net/tiny.sh", "searched_net/medium_mac@4.6G.sh"
FINETUNE = "finetune/medium_img-size@392.sh"
# the 392 px finetune's attention rows: its script's 256 images are per host
# of four cards, 64 a card
FINETUNE_BATCH = 64
STEM_CHANNELS = 24        # a conv stem's norms: 24 channels at half resolution
PREFIX_DROP_PATH = 0.2    # M2/M3's rows: drop path at the Tiny supernet script's rate

# recipes: the 24 published scripts of RECIPE_DIR, each through the port's CLI
# in this process with its own arguments, in an order where every script runs
# after the one whose checkpoint it reads. Set here: IMAGENET_PATH (a view of
# a synthetic folder whose train and val are its sub-train and sub-val),
# MODEL_PATH (the searches: RECIPE_CHECKPOINT in the directory the script
# names, which a one-epoch run writes where the script's default names epoch
# 119's snapshot), one epoch of RECIPE_STEPS steps, the loader workers, and
# each search's population (RECIPE_SEARCH); the working directory is a
# temporary root, so every relative models/... path resolves as the scripts
# write it
RECIPE_DIR = "scripts/vit-sr-nas"
RECIPES = ("super_net/tiny.sh", "super_net/small.sh", "super_net/no_distill/small_conv-patch.sh",
           "super_net/no_distill/small_flexible-conv-patch.sh", "super_net/no_distill/tiny.sh",
           "super_net/no_distill/tiny_conv-patch.sh", "super_net/no_distill/tiny_mh.sh",
           "evolutionary_search/tiny.sh", "evolutionary_search/small_mac@2.9G.sh",
           "evolutionary_search/medium_mac@4.6G.sh",
           "evolutionary_search/no_distill/small_flexible-conv-patch.sh",
           "evolutionary_search/no_distill/tiny_666.sh",
           "evolutionary_search/no_distill/tiny_conv-patch.sh",
           "reference_net/tiny.sh", "reference_net/tiny_conv_patchmixup.sh",
           "searched_net/tiny.sh", "searched_net/no_distill/tiny_conv-patch.sh",
           "searched_net/small_mac@2.9G.sh", "searched_net/no_distill/small_conv-patch_mac@2.9G.sh",
           "searched_net/medium_mac@4.6G.sh",
           "searched_net/no_distill/small_conv-patch_mac@4.6G.sh",
           "finetune/medium_img-size@280.sh", "finetune/medium_img-size@392.sh",
           "eval/small_mac@2.9G.sh")
# the recipes' synthetic image folder: 1000 classes (the heads keep their
# published width), 4 train images per class at 256 px, 1 per class held out
# as the sub-val
FOLDER_CLASSES, FOLDER_TRAIN, FOLDER_HOLDOUT, FOLDER_SIZE = 1000, 4, 1, 256
RECIPE_EPOCHS, RECIPE_STEPS = 1, 2
RECIPE_CHECKPOINT = "checkpoint"
RECIPE_SEARCH = {"--init-popu-size": "8", "--search-iter": "2", "--parent-size": "4",
                 "--mutate-size": "4"}
# the flags the recipes phase may set; any other argument is the script's own
RECIPE_OVERRIDES = ("--data-path", "--model-path", "--epochs", "--max-steps-per-epoch",
                    "--num_workers", *RECIPE_SEARCH, "--batch-size", "--val-bs")
# a script whose own batch one card cannot hold runs at the largest power of
# two that fits (script -> batch); none so far
RECIPE_BATCH_CUTS: dict = {}
# the recipes whose kernel shapes the table checks after the recipes ran
# (read from each script's network_def and token count): K1/K2 at every
# stage's widest heads, K3/K4 (supernets) at every stage's width
RECIPE_KERNEL_SCRIPTS = (("Small supernet", "super_net/small.sh"),
                         ("sr_tiny_666 supernet", "super_net/no_distill/tiny.sh"),
                         ("reference net", "reference_net/tiny.sh"),
                         ("280 px finetune", "finetune/medium_img-size@280.sh"))
# H100 SXM data sheet: HBM bytes/s; dense bf16 tensor-core and f32 flop/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
L2_BYTES = 50 * 2**20
# tolerance: |kernel - plain| <= ATOL * max|plain| + RTOL * |plain|
BF16_TOL = (2e-2, 2e-2)
F32_SUM_TOL = (1e-3, 1e-3)   # gw/gb: the order of the sum differs
F32_TOL = 1e-4               # float32 attention (CUDA cores): atol and rtol
STATS_TOL = (1e-4, 1e-4)
# B1/B2's ReLU: where the statistics are summed in another order, a float32
# pre-activation z moved by at most 2 ulps of its channel's max|z| (a CPU
# model of two orders at the stem's shape), so one within KINK_ULPS such ulps
# of 0 may fall on either side; its dx is not compared, and such elements
# may be at most KINK_SHARE of the activation
KINK_ULPS = 8
KINK_SHARE = 1e-4
# K3/K4's yardstick: PyTorch's layer norm is the function with a full mask
LN_LIBRARY_CALL = "F.layer_norm (dense: the full-mask case of the function)"
# the small net in bf16, card against CPU: on the CPU alone bf16 moves the
# logits by 0.9% of their largest value from f32, the loss by 1.7e-4 and the
# gradient norm by 6.6e-4 (relative); the card rounds at other places
# (tensor-core attention, cuBLAS, cuDNN), so allow about three times that
# for the logits and more for the two scalars
REF_NET_BF16_TOL = {"logits": (3e-2, 3e-2), "loss": 2e-3, "grad_norm": 5e-3}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, args: tuple, reps: int) -> float:
    """Per-launch device time of ``fn(*args)``: the launches are captured in
    one CUDA graph and replayed, so the wrapper's host overhead between them
    drops out, and they rotate over copies of the tensor arguments that
    together exceed twice the L2 cache, so each launch reads from HBM."""
    import torch
    size = nbytes(*(a for a in args if isinstance(a, torch.Tensor)))
    copies = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                       for _ in range(math.ceil(2 * L2_BYTES / size))]
    reps = max(reps, len(copies))
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fn(*copies[i % len(copies)])
    ms = time_ms(graph.replay, 3, warmup=1) / reps
    del graph, copies
    return ms


# kernel classes of a profile, matched in order on the kernel's name
KERNEL_CLASSES = (("attention forward (K1/K6/K8)", ("attn_fwd_kernel",)),
                  ("attention backward (K2/K7/K9)", ("attn_bwd_", "attn_split_")),
                  ("K5 row statistics", ("row_stats_kernel",)),
                  ("K3/K4 masked LN", ("masked_ln_",)),
                  ("convolution", ("fprop", "conv", "cudnn")),
                  ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
                  ("reduction", ("reduce",)),
                  ("elementwise and copies", ("elementwise", "copy")))


def profile_kernels(fn, top: int = 12):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    ``(device-busy ms, wall ms, {class: ms}, [(name, ms, calls), ...])``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    classes: dict = {}
    for name, ms, _ in rows:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    return sum(r[1] for r in rows), wall_ms, classes, rows[:top]


def ptxas_summary(report: str, prefix: str):
    """``[{kernel, registers, spill_stores, spill_loads}]`` for each kernel of
    ``nvcc -Xptxas -v`` output named ``<prefix>...kernel``, with its element
    type, chunks per lane and mode (masked or dense) read from the mangled
    template arguments."""
    import re

    pattern = re.compile(re.escape(prefix) + r"[a-z_]*kernel(?:I(13__nv_bfloat16|f)"
                         r"(?:Li(\d+)E)?(?:Lb([01])E)?E)?")
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = pattern.search(m.group(1))
            cur = None
            if k:
                label = k.group(0).split("I")[0] if k.group(1) else k.group(0)
                if k.group(1):
                    label += " bf16" if k.group(1) == "13__nv_bfloat16" else " f32"
                if k.group(2):
                    label += f" CPL {k.group(2)}"
                if k.group(3) == "1":
                    label += " dense"
                cur = {"kernel": label, "registers": None, "spill_stores": 0,
                       "spill_loads": 0}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def compare(name: str, got, want, tol, floor: float = 0.0) -> float:
    """Max abs error; raises if an element is outside the tolerance
    ``max(atol * max|want|, floor) + rtol * |want|``."""
    import torch
    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    atol, rtol = tol
    bound = torch.clamp(atol * want.abs().max(), min=floor) + rtol * want.abs()
    worst = float((err - bound).max())
    max_err = float(err.max())
    if worst > 0:
        raise AssertionError(f"{name}: max abs err {max_err:.3e} outside tolerance "
                             f"atol={atol}*max|ref| rtol={rtol}")
    return max_err


def relu_kink(name: str, z):
    """The elements of a float32 (B, C, H, W) pre-activation ``z`` within
    ``KINK_ULPS`` ulps of their channel's max|z| of 0; raises where they are
    more than ``KINK_SHARE`` of ``z``."""
    import torch
    top = z.detach().abs().amax(dim=(0, 2, 3), keepdim=True)
    band = z.detach().abs() <= KINK_ULPS * torch.finfo(torch.float32).eps * top
    share = float(band.float().mean())
    if share > KINK_SHARE:
        raise AssertionError(f"{name}: {share:.3e} of the pre-activation lies within "
                             f"{KINK_ULPS} ulps of 0, more than {KINK_SHARE}")
    return band


def check_relu_norm(what: str, got: tuple, want: tuple, z, tol=BF16_TOL) -> dict:
    """A batch norm with the ReLU against the plain ops: ``got`` and ``want``
    each ``(y, running_mean, running_var, (dx, dw, db))``, the gradients empty
    in eval mode, ``want`` with the plain ops' own ReLU, ``z`` their float32
    pre-activation. y within ``tol`` everywhere; the running statistics
    within ``STATS_TOL``, dw and db within ``F32_SUM_TOL``, dx within ``tol``
    outside :func:`relu_kink`'s band. The largest error of each."""
    import torch
    band = relu_kink(what, z)
    y, rm, rv, grads = got
    ry, rrm, rrv, rgrads = want
    errs = {"y": compare(f"{what} y", y, ry, tol)}
    if grads:
        errs["running"] = max(compare(f"{what} running mean", rm, rrm, STATS_TOL),
                              compare(f"{what} running var", rv, rrv, STATS_TOL))
        errs["dx"] = compare(f"{what} dx", torch.where(band, rgrads[0], grads[0]), rgrads[0],
                             tol)
        errs["dw_db"] = max(compare(f"{what} dw", grads[1], rgrads[1], F32_SUM_TOL),
                            compare(f"{what} db", grads[2], rgrads[2], F32_SUM_TOL))
    return errs


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_layout(layout: str, qkv, do, h: int):
    """One layout's form of a ``(B, N, 3W)`` projection and its ``(B, N, W)``
    cotangent: ``(inputs, cotangent, ops, views, cotangent_view)``. ``ops``
    holds the autograd entry point, the kernels' wrappers and the plain
    versions, each called as ``fn(*inputs, scale, h)`` (backward:
    ``fn(*inputs, cotangent, scale, h)``); ``views(inputs)`` gives ``(B, H,
    N, D)`` views of q, k and v for SDPA, ``cotangent_view`` the cotangent's."""
    from vit_search_torch.ops import attention as A

    b, n, w3 = qkv.shape
    d = w3 // (3 * h)
    if layout == "packed":
        ins, g = (qkv,), do
        ops = (A.fused_attention_qkv, A.attention_qkv_fwd_cuda, A.attention_qkv_bwd_cuda,
               A.attention_qkv_plain, A.attention_qkv_bwd_plain)

        def views(t):
            return t[0].view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        g_view = do.view(b, n, h, d).transpose(1, 2)
    elif layout == "separate":
        ins, g = tuple(t.contiguous() for t in qkv.split(w3 // 3, dim=2)), do
        ops = (A.fused_attention_packed, A.attention_fwd_cuda, A.attention_bwd_cuda,
               A.attention_plain, A.attention_bwd_plain)

        def views(t):
            return tuple(x.view(b, n, h, d).transpose(1, 2) for x in t)
        g_view = do.view(b, n, h, d).transpose(1, 2)
    else:
        ins, g = (qkv.transpose(0, 1).contiguous(),), do.transpose(0, 1).contiguous()
        ops = (A.fused_attention_qkv_t, A.attention_qkv_t_fwd_cuda, A.attention_qkv_t_bwd_cuda,
               A.attention_qkv_t_plain, A.attention_qkv_t_bwd_plain)

        def views(t):
            return t[0].view(n, b, 3, h, d).permute(2, 1, 3, 0, 4).unbind(0)
        g_view = g.view(n, b, h, d).permute(1, 2, 0, 3)
    return ins, g, ops, views, g_view


def flat(grads):
    """A backward's result as one tensor (three cotangents side by side)."""
    import torch
    return torch.cat(grads, dim=2) if isinstance(grads, tuple) else grads


def check_attention(stage: str, reps: int, b: int, n: int, h: int, d: int, layout: str,
                    dtype: str = "bfloat16", backward: bool = True):
    """The attention kernels of ``layout`` (K1/K2 packed, K6/K7 separate,
    K8/K9 sequence-major; the backward where ``backward``) against their
    plain versions at ``(b, n, h, d)``, labelled ``stage``."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import attention as A

    w, scale = h * d, d ** -0.5
    torch_dtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    qkv = torch.randn(b, n, 3 * w, device="cuda", generator=gen).to(torch_dtype)
    do = torch.randn(b, n, w, device="cuda", generator=gen).to(torch_dtype)
    ins, g, (entry, fwd_cuda, bwd_cuda, fwd_plain, bwd_plain), views, g_view = attention_layout(
        layout, qkv, do, h)
    del qkv, do
    fwd_name, bwd_name = ATTENTION_KERNELS[layout]
    shape = {"B": b, "N": n, "H": h, "D": d, "dtype": dtype, "layout": layout}
    if dtype == "bfloat16":
        tol, peak = BF16_TOL, PEAK_BF16
        tolerance = f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)"
        if backward:
            shape["bwd_route"] = "split" if A.backward_is_split(n, d) else "one launch"
    else:
        tol, peak = (F32_TOL, F32_TOL), PEAK_F32
        tolerance = f"abs <= {F32_TOL}*max|ref| + {F32_TOL}*|ref| (f32, CUDA cores)"
    what = f"{fwd_name} {stage} B={b}"

    # through autograd, as a caller uses it: the forward launches the forward
    # kernel, the backward the backward kernel; a scoring forward runs under
    # no_grad
    leaves = tuple(t.clone().requires_grad_(backward) for t in ins)
    with torch.set_grad_enabled(backward):
        out = entry(*leaves, scale, h)
    if backward:
        grads = torch.autograd.grad(out, leaves, g)
        grads = grads[0] if len(grads) == 1 else grads
    torch.cuda.synchronize()
    ref_out = fwd_plain(*ins, scale, h)
    err_fwd = compare(what, out, ref_out, tol)
    del out, leaves

    fwd_call_ms = time_ms(lambda: fwd_cuda(*ins, scale, h), reps)
    fwd_ms = graph_ms(fwd_cuda, (*ins, scale, h), reps)
    plain_fwd_ms = time_ms(lambda: fwd_plain(*ins, scale, h), reps)

    # PyTorch's own attention on views of the same tensors, as a yardstick only
    sleaves = tuple(t.clone().requires_grad_(backward) for t in ins)
    q, k, v = views(sleaves)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    with torch.no_grad():
        lib_fwd_ms = time_ms(sdpa, reps)
    bfwd = bound(nbytes(*ins, ref_out), 4.0 * b * h * n * n * d, peak)
    entries = [dict(name=fwd_name, stage=stage, shape=shape,
                    max_abs_err=err_fwd, tolerance=tolerance, ms=fwd_ms, call_ms=fwd_call_ms,
                    plain_ms=plain_fwd_ms, bound_ms=bfwd[0], bound_by=bfwd[1],
                    library_ms=lib_fwd_ms,
                    library_call="F.scaled_dot_product_attention forward")]
    if not backward:
        return entries

    ref_grads = bwd_plain(*ins, g, scale, h)
    err_bwd = compare(f"{bwd_name} {stage} B={b}", flat(grads), flat(ref_grads), tol)
    bwd_call_ms = time_ms(lambda: bwd_cuda(*ins, g, scale, h), reps)
    bwd_ms = graph_ms(bwd_cuda, (*ins, g, scale, h), reps)
    plain_bwd_ms = time_ms(lambda: bwd_plain(*ins, g, scale, h), reps)
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa(), sleaves, g_view), reps)
    bbwd = bound(nbytes(*ins, g, flat(ref_grads)), 10.0 * b * h * n * n * d, peak)
    entries.append(dict(
        name=bwd_name, stage=stage, shape=shape,
        max_abs_err=err_bwd, tolerance=tolerance, ms=bwd_ms, call_ms=bwd_call_ms,
        plain_ms=plain_bwd_ms, bound_ms=bbwd[0], bound_by=bbwd[1],
        library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
        library_call="F.scaled_dot_product_attention (forward+backward) - forward"))
    return entries


def masked_ln_inputs(batch: int, n: int, c: int):
    """Seeded bf16 ``(x, mask, weight, bias, g)`` at ``(batch, n, c)``, a
    mask per example of one of five widths."""
    import numpy as np
    import torch
    from vit_search_torch.ops.masking import make_channel_mask

    gen = torch.Generator(device="cuda").manual_seed(100 + n + c)
    widths = np.array([c, c * 7 // 8, c * 3 // 4, c * 11 // 16, c * 5 // 8])
    counts = torch.as_tensor(np.random.default_rng(n + c).choice(widths, batch), device="cuda")
    mask = make_channel_mask(counts, c, dtype=torch.bfloat16)
    x = (torch.randn(batch, n, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    g = torch.randn(batch, n, c, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)
    return x * mask, mask, w, bias, g


def check_masked_ln(stage: str, reps: int, b: int, n: int, c: int, backward: bool):
    """K3 (and K4 where ``backward``) against the plain versions at ``(b, n,
    c)``, labelled ``stage``."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import kernels
    from vit_search_torch.ops import masked_layer_norm as M

    x, mask, w, bias, g = masked_ln_inputs(b, n, c)
    shape = {"B": b, "N": n, "C": c, "dtype": "bfloat16"}

    y, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
    torch.cuda.synchronize()
    ref_y, ref_stats = M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6)
    err_fwd = max(compare(f"K3 y {stage} B={b}", y, ref_y, BF16_TOL),
                  compare(f"K3 stats {stage} B={b}", stats, ref_stats, STATS_TOL))
    fwd_call_ms = time_ms(lambda: M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6), reps)
    fwd_ms = graph_ms(M.masked_ln_fwd_cuda, (x, mask, w, bias, 1e-6), reps)
    plain_fwd_ms = time_ms(lambda: M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6), reps)
    bfwd = bound(nbytes(x, mask, w, bias, ref_y, ref_stats), 10.0 * x.numel(), PEAK_F32)

    # PyTorch's dense layer norm on the same tensor, as a yardstick only: the
    # full-mask case of the function
    lx = x.clone().requires_grad_(backward)
    lw = w.to(x.dtype).requires_grad_(backward)
    lb = bias.to(x.dtype).requires_grad_(backward)

    def layer_norm():
        return F.layer_norm(lx, (c,), lw, lb, 1e-6)

    with torch.no_grad():
        lib_fwd_ms = time_ms(layer_norm, reps)
    entries = [dict(name="masked_layer_norm_fwd", stage=stage, shape=shape,
                    max_abs_err=err_fwd,
                    tolerance=(f"y: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                               f"stats: {STATS_TOL}"),
                    ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0],
                    bound_by=bfwd[1], library_ms=lib_fwd_ms,
                    library_call=LN_LIBRARY_CALL + " forward",
                    plan=M.launch_plan(b * n, n, c, x.element_size(), False, True,
                                       kernels.num_sms(x), False).__dict__)]
    if not backward:
        return entries

    gx, gw, gb = M.masked_ln_bwd_cuda(x, mask, w, stats, g)
    torch.cuda.synchronize()
    ref_gx, ref_gw, ref_gb = M.masked_ln_bwd_plain(x, mask, w, ref_stats, g)
    err_bwd = compare(f"K4 gx {stage} B={b}", gx, ref_gx, BF16_TOL)
    err_sum = max(compare(f"K4 gw {stage} B={b}", gw, ref_gw, F32_SUM_TOL),
                  compare(f"K4 gb {stage} B={b}", gb, ref_gb, F32_SUM_TOL))
    bwd_call_ms = time_ms(lambda: M.masked_ln_bwd_cuda(x, mask, w, stats, g), reps)
    bwd_ms = graph_ms(M.masked_ln_bwd_cuda, (x, mask, w, stats, g), reps)
    plain_bwd_ms = time_ms(lambda: M.masked_ln_bwd_plain(x, mask, w, stats, g), reps)
    bbwd = bound(nbytes(x, mask, w, ref_stats, g, ref_gx, ref_gw, ref_gb),
                 14.0 * x.numel(), PEAK_F32)
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(layer_norm(), (lx, lw, lb), g), reps)
    entries.append(dict(
        name="masked_layer_norm_bwd", stage=stage, shape=shape,
        max_abs_err=err_bwd, max_abs_err_gw_gb=err_sum,
        tolerance=(f"gx: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                   f"gw/gb: {F32_SUM_TOL}"),
        ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_bwd_ms, bound_ms=bbwd[0],
        bound_by=bbwd[1], library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
        library_call=LN_LIBRARY_CALL + " (forward+backward) - forward",
        plan=M.launch_plan(b * n, n, c, x.element_size(), False, True, kernels.num_sms(x),
                           True).__dict__))
    return entries


def k4_launches(entries, reps: int) -> None:
    """K4 is two launches: the rows (gx and a partial of gw, gb per block),
    then the partials' fold. Device ms of each per call, by kernel name
    (``torch.profiler``), into K4's train-batch entries as ``rows_ms`` and
    ``fold_ms``. Run last: once the profiler has run, later host launches
    are slower."""
    from vit_search_torch.ops import masked_layer_norm as M

    for e in entries:
        if e["name"] != "masked_layer_norm_bwd":
            continue
        x, mask, w, bias, g = masked_ln_inputs(*(e["shape"][k] for k in "BNC"))
        _, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
        _, _, _, top = profile_kernels(
            lambda: [M.masked_ln_bwd_cuda(x, mask, w, stats, g) for _ in range(reps)], top=50)
        split = {("fold" if "fold" in name else "rows"): ms / reps
                 for name, ms, _ in top if "masked_ln_bwd" in name}
        e.update(rows_ms=split.get("rows"), fold_ms=split.get("fold"))
        log(f"K4 {e['stage']} B={e['shape']['B']}: rows {split.get('rows', 0):.4f} ms + "
            f"fold {split.get('fold', 0):.4f} ms per call (profiler); graph {e['ms']:.4f} ms")


def check_layer_norm(label: str, reps: int, b: int, n: int, c: int):
    """K3 and K4 in their dense mode (the layer norm of a net without masks)
    at ``(b, n, c)`` against the plain dense function in float32; ``plain_ms``
    is that function as the port ran it before (autograd through float32
    PyTorch ops), ``library_ms`` ``F.layer_norm``, which the port never calls."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import kernels
    from vit_search_torch.ops import masked_layer_norm as M

    gen = torch.Generator(device="cuda").manual_seed(600 + c)
    x = (torch.randn(b, n, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    g = torch.randn(b, n, c, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)
    shape = {"B": b, "N": n, "C": c, "dtype": "bfloat16"}
    what = f"dense LN {label} (B, N, C) = ({b}, {n}, {c})"

    y, stats = M.layer_norm_fwd_cuda(x, w, bias, 1e-6)
    gx, gw, gb = M.layer_norm_bwd_cuda(x, w, stats, g)
    torch.cuda.synchronize()
    xf, wf, bf = (t.detach().float().requires_grad_() for t in (x, w, bias))
    ref_y = M.layer_norm_plain(xf, wf, bf, 1e-6)
    ref_gx, ref_gw, ref_gb = torch.autograd.grad(ref_y, (xf, wf, bf), g.float())
    with torch.no_grad():
        mu = xf.mean(-1, keepdim=True)
        ref_stats = torch.cat([mu, torch.rsqrt((xf - mu).square().mean(-1, keepdim=True)
                                               + 1e-6)], -1)
    err_fwd = max(compare(f"{what} y", y, ref_y, BF16_TOL),
                  compare(f"{what} stats", stats, ref_stats, STATS_TOL))
    err_bwd = compare(f"{what} gx", gx, ref_gx, BF16_TOL)
    err_sum = max(compare(f"{what} gw", gw, ref_gw, F32_SUM_TOL),
                  compare(f"{what} gb", gb, ref_gb, F32_SUM_TOL))
    del xf, wf, bf, ref_y, ref_gx, ref_stats, mu

    fwd_ms = graph_ms(M.layer_norm_fwd_cuda, (x, w, bias, 1e-6), reps)
    bwd_ms = graph_ms(M.layer_norm_bwd_cuda, (x, w, stats, g), reps)
    fwd_call_ms = time_ms(lambda: M.layer_norm_fwd_cuda(x, w, bias, 1e-6), reps)
    bwd_call_ms = time_ms(lambda: M.layer_norm_bwd_cuda(x, w, stats, g), reps)
    px, pw, pb = (t.detach().clone().requires_grad_() for t in (x, w, bias))

    def plain():
        return M.layer_norm_plain(px, pw, pb, 1e-6)

    with torch.no_grad():
        plain_fwd_ms = time_ms(plain, reps)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(plain(), (px, pw, pb), g),
                           reps) - plain_fwd_ms
    lx, lw, lb = x.clone().requires_grad_(), w.to(x.dtype).requires_grad_(), \
        bias.to(x.dtype).requires_grad_()

    def layer_norm():
        return F.layer_norm(lx, (c,), lw, lb, 1e-6)

    with torch.no_grad():
        lib_fwd_ms = time_ms(layer_norm, reps)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(layer_norm(), (lx, lw, lb), g),
                         reps) - lib_fwd_ms
    bfwd = bound(nbytes(x, w, bias, y, stats), 10.0 * x.numel(), PEAK_F32)
    bbwd = bound(nbytes(x, w, stats, g, gx, gw, gb), 14.0 * x.numel(), PEAK_F32)
    sms = kernels.num_sms(x)
    plans = [M.launch_plan(b * n, n, c, 2, False, True, sms, bwd, dense=True).__dict__
             for bwd in (False, True)]
    log(f"{what}: K3 dense {fwd_ms:.4f} ms, K4 dense {bwd_ms:.4f} ms (bounds {bfwd[0]:.4f} / "
        f"{bbwd[0]:.4f}); plain {plain_fwd_ms:.3f} / {plain_bwd_ms:.3f} ms; F.layer_norm "
        f"{lib_fwd_ms:.4f} / {lib_bwd_ms:.4f} ms")
    return [dict(name="layer_norm_fwd", stage=label, shape=shape,
                 max_abs_err=err_fwd,
                 tolerance=(f"y: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                            f"stats: {STATS_TOL}"),
                 ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0],
                 bound_by=bfwd[1], library_ms=lib_fwd_ms,
                 library_call="F.layer_norm forward (bf16 weight and bias)", plan=plans[0]),
            dict(name="layer_norm_bwd", stage=label, shape=shape,
                 max_abs_err=err_bwd, max_abs_err_gw_gb=err_sum,
                 tolerance=(f"gx: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                            f"gw/gb: {F32_SUM_TOL}"),
                 ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_bwd_ms, bound_ms=bbwd[0],
                 bound_by=bbwd[1], library_ms=lib_bwd_ms,
                 library_call="F.layer_norm (forward+backward) - forward", plan=plans[1])]


def check_prefix_mask(label: str, reps: int, b: int, n: int, c: int, heads: int, hidden: int,
                      masked: bool):
    """M1-M3 at a stage of ``(b, n)`` tokens in bf16, every example kept by
    drop path (rate ``PREFIX_DROP_PATH``) and, where ``masked`` (a
    supernet), every count at its full width, so that each kernel moves
    every byte: M1 forward and backward at the MLP's ``hidden`` width, M2 and
    M3 (its backward) on a residual branch of width ``c``, M3 on the head
    mask at the attention's ``heads`` width. Each against its plain version
    (float32, rounded once); ``library_ms`` is the composition the port ran
    before (``F.gelu`` and the boolean multiply; drop path's divide, fill
    and ``where``, the multiply and the add), ``plain_ms`` the plain
    version. Without ``masked`` (a dense net): M2 and M3 with drop path
    alone."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.models.layers import apply_mask
    from vit_search_torch.ops import prefix_mask as P
    from vit_search_torch.ops.drop_path import drop_path
    from vit_search_torch.ops.masking import make_channel_mask

    gen = torch.Generator(device="cuda").manual_seed(700 + c)
    keep = torch.ones(b, dtype=torch.bool, device="cuda")
    scale = P.drop_path_scale(b, PREFIX_DROP_PATH, "cuda", keep)
    rows, tol = [], f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|"

    def full(width):
        return torch.full((b,), width, dtype=torch.int32, device="cuda") if masked else None

    masks = {w: make_channel_mask(full(w), w) if masked else None for w in (c, heads, hidden)}

    def row(name, what, width, fn, args, plain, library, got, want, nbytes_moved, flops,
            call=None):
        err = compare(f"{name} {label} {what}", got, want, BF16_TOL)
        ms = graph_ms(fn, args, reps)
        call_ms = time_ms(lambda: fn(*args), reps)
        with torch.no_grad():
            plain_ms, library_ms = time_ms(plain, reps), time_ms(library, reps)
        bnd = bound(nbytes_moved, flops, PEAK_F32)
        log(f"{name} {label} {what} (B, N, C) = ({b}, {n}, {width}): {ms:.4f} ms (bound "
            f"{bnd[0]:.4f}, {100 * bnd[0] / ms:.1f}%); plain {plain_ms:.4f}; before "
            f"{library_ms:.4f}")
        rows.append(dict(name=name, stage=f"{label} {what}", shape={
            "B": b, "N": n, "C": width, "dtype": "bfloat16", "masked": masked},
            max_abs_err=err, tolerance=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
            library_call=call or "the port's former composition"))

    def rand(width):
        return torch.randn(b, n, width, device="cuda", generator=gen).to(torch.bfloat16)

    if masked:
        h, g, counts = rand(hidden) * 2, rand(hidden), full(hidden)
        y = P.prefix_gelu_fwd_cuda(h, counts, "exact")
        row("prefix_gelu_fwd", "MLP hidden", hidden, P.prefix_gelu_fwd_cuda,
            (h, counts, "exact"), lambda: P.prefix_gelu_plain(h, counts, "exact"),
            lambda: apply_mask(F.gelu(h), masks[hidden]), y,
            P.prefix_gelu_plain(h, counts, "exact"), nbytes(h, y), 20.0 * h.numel(),
            "F.gelu, then the boolean multiply")
        dh = P.prefix_gelu_bwd_cuda(h, g, counts, "exact")
        ref = h.detach().clone().requires_grad_()
        want = torch.autograd.grad(P.prefix_gelu_plain(ref, counts, "exact"), ref, g)[0]
        row("prefix_gelu_bwd", "MLP hidden", hidden, P.prefix_gelu_bwd_cuda,
            (h, g, counts, "exact"),
            lambda: torch.ops.aten.gelu_backward(g.float() * masks[hidden], h.float()),
            lambda: torch.ops.aten.gelu_backward(apply_mask(g, masks[hidden]), h), dh, want,
            nbytes(h, g, dh), 30.0 * h.numel(),
            "the boolean multiply's backward, then GELU's")
        a, counts = rand(heads), full(heads)
        y = P.prefix_scale_cuda(a, counts, None)
        row("prefix_scale", "head mask", heads, P.prefix_scale_cuda, (a, counts, None),
            lambda: P.prefix_scale_plain(a, counts, None),
            lambda: apply_mask(a, masks[heads]), y, P.prefix_scale_plain(a, counts, None),
            nbytes(a, y), 2.0 * a.numel(), "the boolean multiply")
    x, f, counts = rand(c), rand(c), full(c)
    out = P.branch_add_cuda(x, f, counts, scale)
    row("branch_add", "residual branch", c, P.branch_add_cuda, (x, f, counts, scale),
        lambda: P.branch_add_plain(x, f, counts, scale),
        lambda: x + apply_mask(drop_path(f, PREFIX_DROP_PATH, True, keep=keep), masks[c]),
        out, P.branch_add_plain(x, f, counts, scale), nbytes(x, f, out), 3.0 * x.numel(),
        "drop path (divide, fill, where), the boolean multiply, the add")
    df = P.prefix_scale_cuda(f, counts, scale)
    row("prefix_scale", "residual branch backward", c, P.prefix_scale_cuda, (f, counts, scale),
        lambda: P.prefix_scale_plain(f, counts, scale),
        lambda: drop_path(apply_mask(f, masks[c]), PREFIX_DROP_PATH, True, keep=keep), df,
        P.prefix_scale_plain(f, counts, scale), nbytes(f, df), 2.0 * f.numel(),
        "the boolean multiply, drop path's where and divide")
    return rows


def stem_activation(batch: int, img: int, seed: int):
    """A stem norm's input as the stem makes it: ``conv1`` (3x3, stride 2,
    bf16) of NHWC images viewed as NCHW, in the layout the convolution
    returns."""
    import torch
    from vit_search_torch.models.patch_embed import ConvBnAct, conv2d

    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(batch, img, img, 3, device="cuda", generator=gen)
    layer = ConvBnAct(3, STEM_CHANNELS, 2, torch.bfloat16,
                      torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        return conv2d(images.permute(0, 3, 1, 2), layer.conv, torch.bfloat16)


def layout_of(t) -> str:
    import torch
    if t.is_contiguous():
        return "nchw"
    return "channels_last" if t.is_contiguous(memory_format=torch.channels_last) else "other"


def check_stem_norm(label: str, reps: int, batch: int, img: int, train: bool):
    """B1 (and in train mode B2) at a stem norm's shape, with the ReLU,
    against the float32 PyTorch ops the port ran before, with their own ReLU
    (:func:`check_relu_norm`); ``plain_ms`` is those ops under
    autograd, ``library_ms`` ``F.batch_norm`` (cuDNN) and ``F.relu``, which
    the port never calls. In train mode a row of B1's statistics alone (the
    pass and its fold) comes first. Bounds: three passes over the activation
    forward (two in eval mode, one for the statistics), five backward."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import batch_norm as BN

    x = stem_activation(batch, img, 700 + img)
    c = x.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(701)
    g = torch.empty_like(x).normal_(generator=gen)
    w = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1.0
    bias = torch.randn(c, device="cuda", generator=gen) * 0.5
    stats = [torch.randn(c, device="cuda", generator=gen) * 0.1,
             torch.rand(c, device="cuda", generator=gen) + 0.5]
    shape = {"B": batch, "C": c, "H": x.shape[2], "W": x.shape[3], "dtype": "bfloat16",
             "layout": layout_of(x), "train": train}
    what = f"stem batch norm {label} (B, C, H, W) = {tuple(x.shape)} {shape['layout']}"

    def run(fn):
        rm, rv = (t.clone() for t in stats)
        leaf, lw, lb = (t.clone().requires_grad_(train) for t in (x, w, bias))
        with torch.set_grad_enabled(train):
            y = fn(leaf, lw, lb, rm, rv, train, 0.9, 1e-5, True)
            grads = torch.autograd.grad(y, (leaf, lw, lb), g) if train else ()
        return y.detach(), rm, rv, grads

    with torch.no_grad():
        z = BN.batch_norm_plain(x.float(), w, bias, *(t.clone() for t in stats), train, 0.9,
                                1e-5, False)
    errs = check_relu_norm(what, run(BN.batch_norm), run(BN.batch_norm_plain), z)
    del z

    rm, rv = (t.clone() for t in stats)
    tolerance = (f"y, dx: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                 f"running statistics {STATS_TOL}; dw/db {F32_SUM_TOL}")
    entries = []
    if train:
        mean, var, n = BN.batch_stats_cuda(x, rm, rv, 0.9)
        stats_ms = graph_ms(BN.batch_stats_cuda, (x, rm, rv, 0.9), reps)
        stats_call_ms = time_ms(lambda: BN.batch_stats_cuda(x, rm, rv, 0.9), reps)
        bst = bound(nbytes(x), 0.0, PEAK_F32)
        entries.append(dict(name="batch_norm_stats", stage=label, shape=shape,
                            max_abs_err=errs["running"], errors=errs, tolerance=tolerance,
                            ms=stats_ms, call_ms=stats_call_ms, plain_ms=None, bound_ms=bst[0],
                            bound_by=bst[1], library_ms=None,
                            library_call="none: cuDNN's batch norm has no statistics alone",
                            what="B1 statistics"))

        def forward(x, rm, rv):
            m, v, _ = BN.batch_stats_cuda(x, rm, rv, 0.9)
            return BN.batch_norm_apply_cuda(x, m, v, w, bias, 1e-5, True)
    else:
        mean, var, n = rm, rv, 0

        def forward(x, rm, rv):
            return BN.batch_norm_apply_cuda(x, rm, rv, w, bias, 1e-5, True)
    fwd_ms = graph_ms(forward, (x, rm, rv), reps)
    leaf = x.clone().requires_grad_(train)
    with torch.no_grad():
        fwd_call_ms = time_ms(lambda: BN.batch_norm(leaf, w, bias, rm, rv, train, 0.9, 1e-5,
                                                    True), reps)
    px, pw, pb = (t.clone().requires_grad_(train) for t in (x, w, bias))
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: BN.batch_norm_plain(px, pw, pb, rm, rv, train, 0.9,
                                                           1e-5, True), reps)
    lw, lb = w.clone().requires_grad_(train), bias.clone().requires_grad_(train)

    def library():
        return F.relu(F.batch_norm(leaf, rm, rv, lw, lb, train, 0.1, 1e-5))

    with torch.no_grad():
        lib_fwd_ms = time_ms(library, reps)
    fwd_bytes = (3 if train else 2) * nbytes(x)
    bfwd = bound(fwd_bytes, 0.0, PEAK_F32)
    entries.append(dict(name="batch_norm_apply", stage=label, shape=shape,
                        max_abs_err=errs["y"], errors=errs, tolerance=tolerance,
                        ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0],
                        bound_by=bfwd[1], library_ms=lib_fwd_ms,
                        library_call="F.relu(F.batch_norm(...)) forward (cuDNN)",
                        what=("B1 statistics and normalize" if train else "B1 normalize")))
    line = (f"{what}: B1 {fwd_ms:.4f} ms (bound {bfwd[0]:.4f}, {fwd_call_ms:.4f} per call); "
            f"plain {plain_fwd_ms:.3f} ms; cuDNN {lib_fwd_ms:.4f} ms")
    if train:
        bwd_ms = graph_ms(BN.batch_norm_bwd_cuda,
                          (x, g, mean, var, w, bias, 1e-5, True, 1.0 / n), reps)
        bwd_call_ms = time_ms(lambda: torch.autograd.grad(
            BN.batch_norm(leaf, w, bias, rm, rv, True, 0.9, 1e-5, True), leaf, g),
            reps) - fwd_call_ms
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            BN.batch_norm_plain(px, pw, pb, rm, rv, True, 0.9, 1e-5, True), (px, pw, pb), g),
            reps) - plain_fwd_ms
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(library(), (leaf, lw, lb), g),
                             reps) - lib_fwd_ms
        bbwd = bound(5 * nbytes(x), 0.0, PEAK_F32)
        entries.append(dict(name="batch_norm_bwd", stage=label, shape=shape,
                            max_abs_err=errs["dx"], errors=errs, tolerance=tolerance,
                            ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_bwd_ms,
                            bound_ms=bbwd[0], bound_by=bbwd[1], library_ms=lib_bwd_ms,
                            library_call="F.relu(F.batch_norm(...)) (forward+backward) - forward",
                            what="B2 sums and dx"))
        line += (f"; statistics alone {stats_ms:.4f} ms (bound {bst[0]:.4f}); "
                 f"B2 {bwd_ms:.4f} ms (bound {bbwd[0]:.4f}, {bwd_call_ms:.4f} per call); "
                 f"plain {plain_bwd_ms:.3f} ms; cuDNN {lib_bwd_ms:.4f} ms")
    log(line + f"; errors {json.dumps(errs)}")
    return entries


def stem_module(label: str, reps: int, batch: int, img: int):
    """The whole ``PatchConvEmbed`` of the ViT-ResNAS cells (24 channels,
    embed 240, bf16) through its module, as one row: ``ms`` a train pass
    (forward and backward), ``eval_ms`` an eval forward, each by CUDA events
    around whole calls. Its launches and the tensors it saves are held by
    the gpu tests."""
    import torch
    from vit_search_torch.models.patch_embed import PatchConvEmbed

    stem = PatchConvEmbed(img, 14, 240, STEM_CHANNELS, torch.bfloat16,
                          torch.Generator().manual_seed(0)).cuda()
    images = torch.randn(batch, img, img, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    grad = torch.ones_like(stem(images))
    train_ms = time_ms(lambda: stem(images).backward(grad), reps)
    with torch.no_grad():
        stem.eval()
        eval_ms = time_ms(lambda: stem(images), reps)
    log(f"stem module {label} (B {batch}): forward+backward {train_ms:.3f} ms, eval forward "
        f"{eval_ms:.3f} ms")
    return [dict(name="PatchConvEmbed", stage=label,
                 shape={"B": batch, "img": img, "C": STEM_CHANNELS, "dtype": "bfloat16"},
                 source="vit_search_torch/models/patch_embed.py", replaces=None,
                 max_abs_err=None, tolerance=None, ms=train_ms, eval_ms=eval_ms, call_ms=None,
                 plain_ms=None, bound_ms=None, bound_by=None, library_ms=None,
                 what="the whole conv stem: three Conv-BN-ReLU, the residual add, the "
                      "projection")]


def check_row_stats(stage: str, reps: int, batch: int, n: int, c: int):
    """K5 against its plain version at ``(batch, n, c)``."""
    import torch
    from vit_search_torch.ops import stats as S

    gen = torch.Generator(device="cuda").manual_seed(200 + n)
    x = (torch.randn(batch, n, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    s1, s2 = S.row_sum_sumsq_cuda(x)
    torch.cuda.synchronize()
    ref1, ref2 = S.row_sum_sumsq_plain(x)
    err = max(compare(f"K5 sum {stage} B={batch}", s1, ref1, STATS_TOL),
              compare(f"K5 sumsq {stage} B={batch}", s2, ref2, STATS_TOL))
    call_ms = time_ms(lambda: S.row_sum_sumsq_cuda(x), reps)
    ms = graph_ms(S.row_sum_sumsq_cuda, (x,), reps)
    plain_ms = time_ms(lambda: S.row_sum_sumsq_plain(x), reps)
    b = bound(nbytes(x, ref1, ref2), 3.0 * x.numel(), PEAK_F32)
    return [dict(name="row_sum_sumsq", stage=stage,
                 shape={"B": batch, "N": n, "C": c, "dtype": "bfloat16"}, max_abs_err=err,
                 tolerance=f"abs <= {STATS_TOL[0]}*max|ref| + {STATS_TOL[1]}*|ref| (f32 sums)",
                 ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b[0],
                 bound_by=b[1], library_ms=None,
                 library_call="none: no single PyTorch call returns both sums")]


def lab_cases():
    """The lab's kernels: ``(name, wrapper, plain version, takes do, flops
    per B*H*N*N*D)``."""
    from vit_search_torch.tools import attn_lab as lab

    return (("lab_fwd_t", lab.fwd_T_cuda, lab.fwd_T_plain, False, 4.0),
            ("lab_bwd_t", lab.bwd_T_cuda, lab.bwd_T_plain, True, 10.0),
            ("lab_split_dq", lab.split_dq_cuda, lab.split_dq_plain, True, 6.0),
            ("lab_split_dkv", lab.split_dkv_cuda, lab.split_dkv_plain, True, 8.0))


def lab_base(name: str):
    """K1's or K2's plain function in the output layout of lab kernel
    ``name``, and the K1 or K2 wrapper with the same arguments (K2 only for
    K11, which computes all of its cotangent)."""
    from vit_search_torch.ops import attention as A

    if name == "lab_fwd_t":
        return A.attention_qkv_plain, A.attention_qkv_fwd_cuda
    lo, hi = {"lab_bwd_t": (0, 3), "lab_split_dq": (0, 1), "lab_split_dkv": (1, 3)}[name]

    def plain(qkv, do, scale, h):
        w = do.shape[-1]
        return A.attention_qkv_bwd_plain(qkv, do, scale, h)[..., lo * w:hi * w]

    return plain, A.attention_qkv_bwd_cuda if name == "lab_bwd_t" else None


def mean_abs_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().mean())


def check_lab(stage: str, reps: int, b: int, n: int, h: int, d: int):
    """The attention lab's kernels (K10, K11, K12a, K12b) against their plain
    versions at ``(b, n, h, d)``. Yardstick: SDPA's forward for K10, its
    backward (forward+backward less forward) for K11 and for the pair K12a +
    K12b, whose time as one call (``split_cuda``, the concatenation
    included) the K12 entries carry as ``pair_ms``."""
    import functools

    import torch
    import torch.nn.functional as F
    from vit_search_torch.tools import attn_lab as lab

    w, scale = h * d, d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(400 + n)
    qkv = torch.randn(b, n, 3 * w, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(b, n, w, device="cuda", generator=gen).to(torch.bfloat16)
    shape = {"B": b, "N": n, "H": h, "D": d, "dtype": "bfloat16", "layout": "packed"}
    tolerance = f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)"

    _, _, _, views, g_view = attention_layout("packed", qkv, do, h)
    leaves = (qkv.clone().requires_grad_(),)
    q, k, v = views(leaves)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    with torch.no_grad():
        sdpa_fwd_ms = time_ms(sdpa, reps)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, g_view), reps) - sdpa_fwd_ms
    pair_ms = graph_ms(lab.split_cuda, (qkv, do, scale, h), reps)
    entries = []
    for name, cuda_fn, plain, with_do, flops in lab_cases():
        args = (qkv, do, scale, h) if with_do else (qkv, scale, h)
        got = cuda_fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = compare(f"{name} {stage} B={b}", got, want, BF16_TOL)
        # the distinction the lab shows: the error against K1's / K2's plain
        # function, and (K10, K11) the mean error against the f32 function
        # beside that of K1 / K2 on the card, which must be larger
        base_plain, base_cuda = lab_base(name)
        closer = {}
        if base_cuda is not None:
            f32_args = tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)
            f32 = plain(*f32_args)
            closer = dict(f32_mean_err=mean_abs_err(got, f32),
                          base_f32_mean_err=mean_abs_err(base_cuda(*args), f32))
            if not closer["f32_mean_err"] < closer["base_f32_mean_err"]:
                raise AssertionError(f"{name} {stage}: mean error against the f32 "
                                     f"function {closer['f32_mean_err']:.3e} not below K1/K2's "
                                     f"{closer['base_f32_mean_err']:.3e}")
            del f32
        err_vs_base = float((got.float() - base_plain(*args).float()).abs().max())
        del got
        log(f"{name} {stage}: max abs err {err:.3e} against its plain version, "
            f"{err_vs_base:.3e} against K1/K2's"
            + ("".join(f", {k} {v:.3e}" for k, v in closer.items())))
        bnd = bound(nbytes(*args[:-2], want), flops * b * h * n * n * d, PEAK_BF16)
        e = dict(name=name, stage=stage, shape=shape, max_abs_err=err,
                 err_vs_base=err_vs_base, **closer,
                 tolerance=tolerance, ms=graph_ms(cuda_fn, args, reps),
                 call_ms=time_ms(functools.partial(cuda_fn, *args), reps),
                 plain_ms=time_ms(functools.partial(plain, *args), reps), bound_ms=bnd[0],
                 bound_by=bnd[1])
        if name == "lab_fwd_t":
            e.update(library_ms=sdpa_fwd_ms, library_call="F.scaled_dot_product_attention forward")
        else:
            e.update(library_ms=sdpa_bwd_ms,
                     library_call="F.scaled_dot_product_attention (forward+backward) - forward")
        if name.startswith("lab_split"):
            e.update(pair_ms=pair_ms, library_call=e["library_call"] + ": dq, dk and dv, the "
                     "pair K12a + K12b's function (compare with pair_ms)")
        entries.append(e)
    return entries


def check_launches(launches: dict, per: dict, passes: int, what: str) -> None:
    """Every kernel launched exactly ``per[name]`` times per pass."""
    for name, count in per.items():
        if launches[name] != count * passes:
            raise AssertionError(f"{name}: {launches[name]} launches in {passes} {what}, "
                                 f"expected {count} per pass")


def synthetic_batch(batch: int, img: int, seed: int):
    """Random uint8 NHWC images and labels on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (batch, img, img, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    return images, torch.randint(0, 1000, (batch,), device="cuda", generator=gen)


def run_steps(what: str, step, images, labels, counts, steps: int, warmup: int,
              per_step: dict, top: int = 12):
    """``warmup`` untimed steps, then ``steps`` timed ones (the launches of
    this window counted, exactly ``per_step`` each), then one more step
    under the profiler. ``counts()`` gives each step's keep counts."""
    import torch
    from vit_search_torch.ops import kernels

    batch = images.shape[0]
    t0 = time.perf_counter()
    warm = [step(images, labels, counts()) for _ in range(warmup)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = [step(images, labels, counts()) for _ in range(steps)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    losses = [float(m["loss"]) for m in warm + metrics]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    check_launches(launches, per_step, steps, f"{what} steps")
    # one more step under the profiler, outside the counted window
    busy_ms, wall_ms, classes, rows = profile_kernels(
        lambda: step(images, labels, counts()), top=top)
    by_class = ", ".join(f"{c} {ms:.1f}" for c, ms in sorted(classes.items(),
                                                            key=lambda kv: -kv[1]))
    log(f"{what}: profiled step {busy_ms:.1f} ms device-busy of "
        f"{wall_ms:.1f} ms ({by_class})")
    return {"steps": steps, "warmup_steps": warmup, "batch": batch,
            "imgs_per_s": batch * steps / elapsed, "step_ms": 1e3 * elapsed / steps,
            "warmup_s": warm_s, "max_memory_allocated_bytes": peak,
            "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in warm + metrics],
            "launches": launches,
            "profiled_step": {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
                              "by_class_ms": classes, "top_kernels": rows}}


def supernet_step(network_def=None, space: str = "sr_tiny_mh", batch: int = BATCH,
                  example_per_arch: int = EXAMPLE_PER_ARCH, drop_path: float = 0.2,
                  gelu: str = "tanh", patch_len: int = 4):
    """A supernet's train step and its keep-count sampler: by default the
    full-width ``SUPERNET_SR_TINY_MH`` supernet at ``BATCH``, token mixup,
    drop_path 0.2, tanh GELU, bf16, AdamW. A supernet recipe passes its
    script's values."""
    import gc

    import torch
    from vit_search_torch.arch import presets, spaces
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule,
                                        make_optimizer, make_train_step)

    gc.collect()   # an earlier model and optimizer off the card
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    net = network_def or presets.SUPERNET_SR_TINY_MH
    model = create_model("flexible_vit_sr_patch14_224_patch_output_supernet",
                         network_def=net, dtype=torch.bfloat16, drop_path_rate=drop_path,
                         gelu=gelu, seed=0)
    ocfg = OptimConfig(base_lr=5e-4, warmup_epochs=5, epochs=120, steps_per_epoch=1000,
                       global_batch_size=batch)
    sched = SupernetSchedules(net, spaces.get_space(space), example_per_arch=example_per_arch,
                              num_warmup_epochs=0, arch_mode="multi")
    step = make_train_step(model, make_optimizer(ocfg, model),
                           TrainConfig(num_classes=1000, mixup_mode="token", patch_len=patch_len),
                           schedule=lr_schedule(ocfg), counts_unpack=sched.unpack, seed=0)
    return step, sched


def script_command(path: str, env=None):
    """``(cli, argv)`` of a published script: the CLI it runs (``train`` or
    ``evo_search``) and its arguments from the one after ``-m
    vit_search_tpu.cli.<cli>`` on, each shell variable that the script sets as
    ``VAR="${VAR:-default}"`` taken from ``env`` where given, else its
    default."""
    import re
    import shlex

    with open(os.path.join(HERE, path)) as f:
        text = f.read()
    values = dict(re.findall(r'^(\w+)="\$\{\1:-([^}]*)\}"', text, re.M))
    values.update({k: v for k, v in (env or {}).items() if k in values})
    words = shlex.split(re.sub(r"\\\n", " ", text), comments=True)
    module = next(w for w in words if w.startswith("vit_search_tpu.cli."))
    argv = [re.sub(r"\$\{?(\w+)\}?", lambda m: values[m.group(1)], w)
            for w in words[words.index(module) + 1:]]
    return module.rsplit(".", 1)[1], argv


def host_cores() -> int:
    return len(os.sched_getaffinity(0))


def make_folder(root: str) -> float:
    """The recipes' synthetic image folder (``make_synthfolder``, one
    process per host core) with its holdout split (``build_subsets``);
    returns the seconds it took."""
    import contextlib

    from vit_search_torch.data import build_subsets
    from vit_search_torch.tools.make_synthfolder import generate

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        generate(root, num_classes=FOLDER_CLASSES, train_per_class=FOLDER_TRAIN,
                 val_per_class=0, size=FOLDER_SIZE, seed=0, workers=host_cores())
    build_subsets(root, per_class=FOLDER_HOLDOUT, seed=0)
    return time.perf_counter() - t0


def _make_folder_into(folder: str, seconds) -> None:
    seconds.value = make_folder(folder)


def start_folder(folder: str):
    """:func:`make_folder` in a process of its own, so that the host makes the
    folder while the card runs the table: ``(process, seconds)``,
    where ``seconds.value`` receives its time once it ends."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    seconds = ctx.Value("d", -1.0)
    proc = ctx.Process(target=_make_folder_into, args=(folder, seconds))
    proc.start()
    return proc, seconds


def stop(proc, scratch: str) -> None:
    """End ``proc`` if it still runs and remove ``scratch``."""
    if proc.is_alive():
        proc.terminate()
    proc.join()
    shutil.rmtree(scratch, ignore_errors=True)


def with_flags(argv: list, flags: dict) -> list:
    """``argv`` with each flag of ``flags`` set to its value (replaced where
    present, else added)."""
    argv = list(argv)
    for flag, value in flags.items():
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    return argv


def kernel_attention_blocks(network_def, img_size: int, patch_size: int = 14,
                            num_tokens: int = 1) -> int:
    """The existing attention blocks of ``network_def`` at ``img_size`` that
    take the fused kernel: ``ops.attention.supported`` at each stage's token
    count and head dim (below N = 8 the model runs the plain version)."""
    from vit_search_torch.arch import network_def as nd
    from vit_search_torch.ops.attention import supported

    grid, count = img_size // patch_size, 0
    for block in network_def[1:-1]:
        if nd.block_type(block) == nd.TRANSFORMER:
            tdef = nd.transformer_def(block)
            count += bool(tdef.exists and supported(grid * grid + num_tokens, tdef.head_dim, 0.0))
        else:
            grid //= 2
    return count


def recipe_argv(script: str, data_path: str, workers: int):
    """``(cli, argv)`` of a published script as the recipes phase runs it:
    the script's own arguments with IMAGENET_PATH set to ``data_path``,
    MODEL_PATH (the searches) to ``RECIPE_CHECKPOINT`` in the directory that
    the script's default names, ``workers`` loader workers, one epoch of
    ``RECIPE_STEPS`` steps (training, not ``--eval``), the population of
    ``RECIPE_SEARCH`` (searches), and ``RECIPE_BATCH_CUTS``' batch where it
    names the script. Needs no card."""
    path = os.path.join(RECIPE_DIR, script)
    _, own = script_command(path)
    env = {"IMAGENET_PATH": data_path}
    if "--model-path" in own:
        default = own[own.index("--model-path") + 1]
        env["MODEL_PATH"] = os.path.join(os.path.dirname(default), RECIPE_CHECKPOINT)
    cli, argv = script_command(path, env)
    flags = {"--num_workers": str(workers)}
    if cli == "evo_search":
        flags.update(RECIPE_SEARCH)
    elif "--eval" not in argv:
        flags.update({"--epochs": str(RECIPE_EPOCHS), "--max-steps-per-epoch": str(RECIPE_STEPS)})
    if script in RECIPE_BATCH_CUTS:
        flags["--batch-size"] = str(RECIPE_BATCH_CUTS[script])
    return cli, with_flags(argv, flags)


def recipe_reads(argv: list) -> list:
    """The checkpoint directories a recipe's arguments read."""
    return [argv[argv.index(flag) + 1] for flag in ("--model-path", "--finetune", "--resume")
            if flag in argv]


def dense_lns(network_def) -> int:
    """The layer norms of a net: two per transformer block, one per
    spatial-reduction block, one final."""
    from vit_search_torch.arch import network_def as nd

    return (2 * nd.existing_depth(network_def) + 1
            + sum(nd.block_type(b) == nd.SPATIAL_REDUCTION for b in network_def))


def stem_norms(network_def) -> int:
    """The batch norms of a net: a conv stem's, none in a linear stem."""
    from vit_search_torch.arch import network_def as nd

    return 0 if nd.block_type(network_def[0]) == nd.LINEAR_EMBED else STEM_NORMS


def prefix_launches(network_def, masked: bool, drop_path: float):
    """M1-M3's launches per train step and per eval (or scoring) forward. A
    masked net (a supernet: every block has head and hidden counts, every
    branch the embed count): M1 once each way a block, M2 once a branch, M3
    for each head mask each way and each branch's backward. A dense net:
    M2 and M3 (its backward) once on each branch whose drop-path rate is
    above 0 (the rates rise from 0 at the first block), none in eval."""
    from vit_search_torch.arch import network_def as nd

    depth = nd.existing_depth(network_def)
    if masked:
        return (dict(prefix_gelu_fwd=depth, prefix_gelu_bwd=depth, branch_add=2 * depth,
                     prefix_scale=4 * depth),
                dict(prefix_gelu_fwd=depth, branch_add=2 * depth, prefix_scale=depth))
    branches = 2 * (depth - 1) if drop_path > 0.0 and depth > 1 else 0
    return dict(branch_add=branches, prefix_scale=branches), {}


def recipe_launches(network_def, img_size: int, masked: bool, drop_path: float):
    """Launches per train step and per eval (or scoring) forward of a recipe's
    net, counted from its network_def: K1/K2 on each attention block that
    takes the kernel (N >= 8); K3/K4 on each layer norm (``dense_lns``),
    masked where ``masked`` (a supernet), else in their dense mode; B1/B2 on
    a conv stem's norms (``stem_norms``); M1-M3 (``prefix_launches``)."""
    attention = kernel_attention_blocks(network_def, img_size)
    lns, norms = dense_lns(network_def), stem_norms(network_def)
    fwd, bwd = (("masked_layer_norm_fwd", "masked_layer_norm_bwd") if masked
                else ("layer_norm_fwd", "layer_norm_bwd"))
    step, forward = prefix_launches(network_def, masked, drop_path)
    return (with_stem(per_pass(attention_qkv_fwd=attention, attention_qkv_bwd=attention,
                               **{fwd: lns, bwd: lns}, **step), norms, True),
            with_stem(per_pass(attention_qkv_fwd=attention, **{fwd: lns}, **forward), norms,
                      False))


def net_stages(network_def, img_size: int, patch_size: int = 14) -> list:
    """Each stage of a net at ``img_size``: ``{"N", "C", "H", "D", "F",
    "blocks"}``, its token count, embedding width, widest attention's heads
    and head dim, widest MLP hidden width, and its transformer blocks."""
    from vit_search_torch.arch import network_def as nd

    grid, stages, n = img_size // patch_size, [], None
    for block in network_def[1:-1]:
        if nd.block_type(block) != nd.TRANSFORMER:
            grid //= 2
            continue
        t = nd.transformer_def(block)
        if n != grid * grid + 1:
            n = grid * grid + 1
            stages.append({"N": n, "C": t.embed_dim, "H": 0, "D": t.head_dim, "F": 0,
                           "blocks": 0})
        st = stages[-1]
        st["blocks"] += 1
        st["F"] = max(st["F"], t.ffn_hidden)
        if t.num_heads > st["H"]:
            st.update(H=t.num_heads, D=t.head_dim)
    return stages


def recipe_net(script: str):
    """``(network_def, input size, masked, drop path)`` of a recipe's net, from
    its own arguments as its CLI parses them: masked (the masked layer norm,
    keep counts) in a supernet or a search; a search trains nothing."""
    from vit_search_torch import models
    from vit_search_torch.arch import parse_network_def
    from vit_search_torch.cli import evo_search as evo_cli
    from vit_search_torch.cli import train as train_cli

    cli, argv = recipe_argv(script, "", 1)
    args = (train_cli if cli == "train" else evo_cli).get_args_parser().parse_args(argv)
    masked = cli == "evo_search" or models.is_supernet_model(args.model)
    return (parse_network_def(args.network_def), args.input_size, masked,
            getattr(args, "drop_path", 0.0))


def recipe_stages(script: str):
    """``[(N, C, heads, head_dim)]`` of each stage of a recipe's net at its
    input size, from its network_def (``net_stages``)."""
    net, size, _, _ = recipe_net(script)
    return [(st["N"], st["C"], st["H"], st["D"]) for st in net_stages(net, size)]


def recipe_data(folder: str, root: str) -> str:
    """The recipes' data: a view of ``folder`` whose ``train`` and ``val``
    are its ``sub-train`` and ``sub-val`` (the scripts without
    ``--use-holdout``), beside the two under their own names."""
    view = os.path.join(root, "recipes_data")
    os.makedirs(view)
    for name, target in (("train", "sub-train"), ("val", "sub-val"), ("sub-train", "sub-train"),
                         ("sub-val", "sub-val")):
        os.symlink(os.path.join(folder, target), os.path.join(view, name))
    return view


def search_candidates(args) -> list:
    """``[(network_def, score)]`` of every generation a search CLI run wrote."""
    import pickle

    out = []
    for i in range(args.search_iter):
        with open(os.path.join(args.output_dir, f"iter@{i}_popu.pickle"), "rb") as f:
            out.append(pickle.load(f))
    return out


def recipes(folder: str, root: str):
    """The 24 published scripts through the port's CLIs, in ``RECIPES``'
    order, in this process with the working directory at a temporary root
    (``recipe_argv``: the scripts' own arguments but for the overrides of
    ``RECIPE_OVERRIDES``). For each script: it returns without an exception;
    every loss it logs is finite; every eval's acc1 (the per-epoch eval, the
    EMA's, ``--eval``) is in [0, 100]; every search candidate is within its
    MAC band and scores in [0, 100]; the checkpoints that later scripts read
    from its output directory exist; K1-K4 launch exactly their counts per
    train step and per eval or scoring forward (``recipe_launches``); its
    peak memory is under the card's. One line per script on stderr."""
    import contextlib
    import gc

    import torch
    from vit_search_torch import models
    from vit_search_torch.arch import ComputationEstimator, parse_network_def
    from vit_search_torch.cli import evo_search as evo_cli
    from vit_search_torch.cli import train as train_cli
    from vit_search_torch.ops import kernels
    from vit_search_torch.search.generators import RESOURCE_LOWER_BOUND

    data_path = recipe_data(folder, root)
    work = os.path.join(root, "recipes")
    os.makedirs(work)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    train_images = FOLDER_CLASSES * (FOLDER_TRAIN - FOLDER_HOLDOUT)
    val_images = FOLDER_CLASSES * FOLDER_HOLDOUT
    commands = [(script, *recipe_argv(script, data_path, host_cores())) for script in RECIPES]
    runs, outputs, cwd, t_phase = {}, set(), os.getcwd(), time.perf_counter()
    os.chdir(work)
    try:
        for i, (script, cli, argv) in enumerate(commands):
            module = train_cli if cli == "train" else evo_cli
            args = module.get_args_parser().parse_args(argv)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):   # the CLI's console log
                result = module.main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counted = {k.name: k.launches for k in kernels.KERNELS}
            launches = {name: counted.get(name, 0) for name in KERNEL_NAMES}

            net = parse_network_def(args.network_def)
            masked = cli == "evo_search" or models.is_supernet_model(args.model)
            per_step, per_forward = recipe_launches(net, args.input_size, masked,
                                                    getattr(args, "drop_path", 0.0))
            run = {"cli": cli, "argv": argv, "seconds": seconds, "peak_bytes": peak,
                   "launches": launches, "per_step": per_step, "per_forward": per_forward}
            if cli == "train":
                if args.eval:
                    steps, passes, accs = 0, 1, [result["eval"]["acc1"]]
                else:
                    steps = args.epochs * min(args.max_steps_per_epoch,
                                              train_images // args.batch_size)
                    passes = args.epochs * (1 + bool(args.model_ema)) + bool(args.finetune)
                    accs = [result["test_acc1"]] + ([result["ema_test_acc1"]]
                                                   if args.model_ema else [])
                    if not math.isfinite(result["train_loss"]):
                        raise AssertionError(f"recipes: {script}: loss {result['train_loss']}")
                    run.update(train_loss=result["train_loss"],
                               imgs_per_s=result["train_imgs_per_sec"])
                forwards = passes * math.ceil(val_images / args.val_bs)
                run.update(batch=args.batch_size, acc1=accs)
                if not all(0.0 <= a <= 100.0 for a in accs):
                    raise AssertionError(f"recipes: {script}: acc1 {accs}")
            else:
                generations = search_candidates(args)
                est = ComputationEstimator(distill="distill" in args.model,
                                           input_resolution=args.input_size,
                                           patch_size=args.patch_size or 14)
                lo, hi = RESOURCE_LOWER_BOUND * args.constraint_value, args.constraint_value
                sizes = [args.init_popu_size] + [2 * args.mutate_size] * (args.search_iter - 1)
                macs = [est(d) for gen in generations for d, _ in gen]
                scores = [s for gen in generations for _, s in gen]
                if [len(gen) for gen in generations] != sizes:
                    raise AssertionError(f"recipes: {script}: generations of "
                                         f"{[len(g) for g in generations]}, expected {sizes}")
                if not all(lo <= m <= hi for m in macs):
                    raise AssertionError(f"recipes: {script}: MACs outside [{lo}, {hi}]: {macs}")
                if not all(0.0 <= s <= 100.0 for s in scores):
                    raise AssertionError(f"recipes: {script}: scores {scores}")
                steps = 0
                forwards = (sum(-(-n // args.arch_batch) for n in sizes)
                            * math.ceil(val_images / args.val_bs))
                run.update(batch=args.val_bs * args.arch_batch, candidates=len(macs),
                           candidates_per_s=len(macs) / seconds, macs=[min(macs), max(macs)],
                           best_score=result["best_score"])
            want = {name: per_step[name] * steps + per_forward[name] * forwards
                    for name in KERNEL_NAMES}
            if launches != want:
                raise AssertionError(f"recipes: {script}: launches {launches}, expected {want} "
                                     f"({steps} train steps, {forwards} forwards)")
            if peak >= card_bytes:
                raise AssertionError(f"recipes: {script}: peak {peak} B of the card's "
                                     f"{card_bytes}")
            # the checkpoints that later scripts read from this one's output;
            # an output no later script reads is removed (the machine's disk
            # holds a few of the scripts' states, not all of them)
            if getattr(args, "output_dir", ""):
                outputs.add(args.output_dir.rstrip("/"))
            reads = [path for _, _, later in commands[i + 1:] for path in recipe_reads(later)]
            for path in reads:
                if args.output_dir and path.startswith(args.output_dir.rstrip("/") + "/"):
                    if not os.path.isfile(os.path.join(path, "state.pt")):
                        raise AssertionError(f"recipes: {script} left no {path}")
            for out in sorted(outputs):
                if not any(path.startswith(out + "/") for path in reads):
                    shutil.rmtree(out)
                    outputs.discard(out)
            run.update(steps=steps, forwards=forwards)
            runs[script] = run
            cut = (f" (cut from the script's {script_batch(script)}: one card)"
                   if script in RECIPE_BATCH_CUTS else "")
            rate = (f"throughput {run['imgs_per_s']:.1f} imgs/s" if "imgs_per_s" in run
                    else f"{run['candidates']} candidates, {run['candidates_per_s']:.2f}/s"
                    if cli == "evo_search" else "eval only")
            log(f"recipes: {script}: batch {run['batch']}{cut}, val-bs {args.val_bs}, {steps} "
                f"steps, {forwards} "
                f"eval forwards, {rate}, acc1 {run.get('acc1', run.get('best_score'))}, peak "
                f"{peak / 2**30:.2f} GiB, K1/K2/K3/K4 " + "/".join(
                    str(launches[k]) for k in KERNEL_NAMES[:4]) + ", dense K3/K4 "
                f"{launches['layer_norm_fwd']}/{launches['layer_norm_bwd']}, M1/M1 bwd/M2/M3 "
                + "/".join(str(launches[k]) for k in KERNEL_NAMES[-4:]) + f", {seconds:.1f} s")
    finally:
        os.chdir(cwd)
    return {"scripts": runs, "seconds": time.perf_counter() - t_phase}


def script_batch(script: str) -> int:
    """A published script's own ``--batch-size``."""
    _, argv = script_command(os.path.join(RECIPE_DIR, script))
    return int(argv[argv.index("--batch-size") + 1])


def recipe_profile(script: str, steps: int, warmup: int):
    """A token-mixup supernet recipe's train step (``supernet_step`` with the
    script's net, space, batch, examples per architecture, drop path, GELU
    and patch length) on device batches, no host decode, timed by
    ``run_steps`` with one step under the profiler."""
    import numpy as np
    from vit_search_torch.arch import parse_network_def
    from vit_search_torch.cli import train as train_cli

    _, argv = recipe_argv(script, "", 1)
    args = train_cli.get_args_parser().parse_args(argv)
    net = parse_network_def(args.network_def)
    step, sched = supernet_step(net, args.search_space, args.batch_size, args.example_per_arch,
                                args.drop_path, args.gelu, args.mixup_patch_len)
    images, labels = synthetic_batch(args.batch_size, args.input_size, 6)
    rng = np.random.default_rng(0)
    return run_steps(script, step, images, labels,
                     lambda: sched.sample_packed(rng, args.batch_size), steps, warmup,
                     recipe_launches(net, args.input_size, True, args.drop_path)[0])


def k2_route_by_name(n: int, h: int, d: int, batch: int) -> dict:
    """K2's launches by kernel name over one bf16 forward and backward at
    ``(batch, N, heads, head_dim)`` through ``fused_attention_qkv``, under
    the profiler, against the route ``backward_is_split`` gives: the
    one-launch body (``attn_bwd_kernel``) or the split route
    (``attn_split_dq_kernel`` then ``attn_split_dkv_kernel``)."""
    import torch
    from vit_search_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(n + h + d)
    qkv = torch.randn(batch, n, 3 * h * d, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(batch, n, h * d, device="cuda", generator=gen).to(torch.bfloat16)
    leaf = qkv.requires_grad_()

    def step():   # through autograd, as the model calls it
        torch.autograd.grad(A.fused_attention_qkv(leaf, d ** -0.5, h), leaf, do)

    # the profiler now and then returns a trace without device events (the
    # card's kernel records missed): profile again until it holds some
    for _ in range(5):
        _, _, _, top = profile_kernels(step, top=50)
        if top:
            break
    calls = {name: sum(c for key, _, c in top if name in key)
             for name in ("attn_bwd_kernel", "attn_split_dq_kernel", "attn_split_dkv_kernel")}
    split = A.backward_is_split(n, d)
    want = ({"attn_bwd_kernel": 0, "attn_split_dq_kernel": 1, "attn_split_dkv_kernel": 1}
            if split else
            {"attn_bwd_kernel": 1, "attn_split_dq_kernel": 0, "attn_split_dkv_kernel": 0})
    if calls != want:
        raise AssertionError(f"K2 at N={n}, D={d}: launches by name {calls}, the "
                             f"{'split' if split else 'one-launch'} route expects {want}")
    return {"bwd_route": "split" if split else "one launch", "launches_by_name": calls}


def recipe_k2_routes() -> dict:
    """:func:`k2_route_by_name` at every stage of ``RECIPE_KERNEL_SCRIPTS``'
    nets at each script's batch, ``{"N,H,D": ...}``. Run before any other
    profiler session of the process: late in a long run a session has twice
    recorded none of K2's launches."""
    routes = {}
    for _, script in RECIPE_KERNEL_SCRIPTS:
        _, argv = recipe_argv(script, "", 1)
        batch = int(argv[argv.index("--batch-size") + 1])
        for n, _, h, d in recipe_stages(script):
            routes[f"{n},{h},{d}"] = k2_route_by_name(n, h, d, batch)
    return routes


def check_recipe_kernels(reps: int, routes: dict):
    """K1/K2 (bf16) against their plain versions at the widest heads of each
    stage of ``RECIPE_KERNEL_SCRIPTS``' nets, at each script's batch, with
    K2's route by kernel name from ``routes`` (``recipe_k2_routes``); K3/K4
    at each stage width of the supernets among them. Each row names its
    script as its net."""
    entries = []
    for label, script in RECIPE_KERNEL_SCRIPTS:
        _, argv = recipe_argv(script, "", 1)
        batch = int(argv[argv.index("--batch-size") + 1])
        for i, (n, c, h, d) in enumerate(recipe_stages(script)):
            stage = f"{label} stage {i + 1}"
            rows = check_attention(stage, reps, batch, n, h, d, "packed")
            for e in rows:
                if e["name"] == "attention_qkv_bwd":
                    e.update(routes[f"{n},{h},{d}"])
            if recipe_net(script)[2]:
                rows += check_masked_ln(stage, reps, batch, n, c, True)
            entries += [dict(e, net=script) for e in rows]
    return entries


def window_inputs(bw: int, n: int, h: int, shift: int, r: int, seed: int):
    """A windowed-attention call's bf16 projection and cotangent, a scale
    near 10 per head, a bias in (0, 16) and, shifted, the region ids."""
    import torch
    from vit_search_torch.models import swin_v2

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(bw, n, 3 * h * 32, device="cuda", generator=gen).bfloat16()
    g = torch.randn(bw, n, h * 32, device="cuda", generator=gen).bfloat16()
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn(h, device="cuda", generator=gen))
    bias = 16 * torch.sigmoid(torch.randn(h, n, n, device="cuda", generator=gen))
    regions = swin_v2.shift_regions(r, int(math.sqrt(n)), shift).cuda() if shift else None
    return qkv, g, scale, bias, regions


def window_work(bw: int, n: int, h: int, d: int, backward: bool):
    """``(bytes, operations)`` of the windowed attention: the projection,
    output and cotangents in bf16, the f32 bias read once (and its gradient
    written once); two N^2 d products forward, five backward."""
    w, table = h * d, 4.0 * h * n * n
    if backward:
        return 2.0 * bw * n * 7 * w + 2 * table, 10.0 * bw * h * n * n * d
    return 2.0 * bw * n * 4 * w + table, 4.0 * bw * h * n * n * d


def check_window_attention(label: str, reps: int, bw: int, n: int, h: int, shift: int,
                           r: int):
    """The windowed cosine attention (SwinV2) at a SwinV2-B stage shape
    (``bw`` windows of ``n`` tokens, ``h`` heads of 32, the shift and the
    stage's resolution ``r``): out, dqkv, the scale's and the bias's
    gradients against ``window_attention_plain`` with q' and k' rounded as
    the kernels round them (``BF16_TOL``), one counted launch of each record
    per autograd call, and each direction timed beside its bound, the plain
    version and SDPA with a float ``attn_mask`` (the bias plus the shift
    mask)."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import window_attention as W

    qkv, g, scale, bias, regions = window_inputs(bw, n, h, shift, r, n + h + shift)
    shape = {"B": bw, "N": n, "H": h, "D": 32, "shift": shift, "dtype": "bfloat16"}
    leaves = [qkv.clone().requires_grad_(), scale.clone().requires_grad_(),
              bias.clone().requires_grad_()]
    before = (W.WA_FWD.launches, W.WA_BWD.launches)
    out = W.window_attention(leaves[0], leaves[1], leaves[2], regions, h)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    if (W.WA_FWD.launches, W.WA_BWD.launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"window attention {label}: launches not counted once")
    ref_leaves = [qkv.float().requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
    ref = W.window_attention_plain(*ref_leaves, regions, h, rounded=True)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g.float())
    err_fwd = compare(f"window attention forward {label}", out, ref, BF16_TOL)
    err_bwd = max(compare(f"window attention backward {label} ({what})", a, b, BF16_TOL)
                  for what, a, b in zip(("dqkv", "dscale", "dbias"), grads, ref_grads))
    del out, grads, ref, ref_grads, ref_leaves, leaves
    _, qkvn, rn = W.window_attention_fwd_cuda(qkv, scale, bias, regions, h)
    fwd_ms = graph_ms(W.window_attention_fwd_cuda, (qkv, scale, bias, regions, h), reps)
    bwd_ms = graph_ms(W.window_attention_bwd_cuda, (qkvn, rn, scale, bias, regions, g, h),
                      reps)
    fwd_call_ms = time_ms(lambda: W.window_attention_fwd_cuda(qkv, scale, bias, regions, h),
                          reps)
    bwd_call_ms = time_ms(lambda: W.window_attention_bwd_cuda(qkvn, rn, scale, bias, regions,
                                                              g, h), reps)
    pleaves = [qkv.float().requires_grad_(), scale.clone().requires_grad_(),
               bias.clone().requires_grad_()]
    plain_fwd_ms = time_ms(lambda: W.window_attention_plain(qkv, scale, bias, regions, h),
                           reps)
    plain_all_ms = time_ms(lambda: torch.autograd.grad(
        W.window_attention_plain(*pleaves, regions, h), pleaves, g.float()), reps)
    # SDPA over q' and k' with the bias and shift mask as a float mask
    q, k, v = qkv.view(bw, n, 3, h, 32).permute(2, 0, 3, 1, 4)
    mask = bias.bfloat16().expand(bw, h, n, n)
    if regions is not None:
        mask = (bias[None] + W.region_mask(regions)[:, None]).bfloat16().repeat(
            bw // regions.shape[0], 1, 1, 1)
    sq = (F.normalize(q.float(), dim=-1) * scale.view(1, h, 1, 1)).bfloat16()
    sk = F.normalize(k.float(), dim=-1).bfloat16()
    sl = [t.detach().clone().requires_grad_() for t in (sq, sk, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*sl, attn_mask=mask, scale=1.0)

    with torch.no_grad():
        lib_fwd_ms = time_ms(sdpa, reps)
    g_view = g.view(bw, n, h, 32).transpose(1, 2)
    lib_all_ms = time_ms(lambda: torch.autograd.grad(sdpa(), sl, g_view), reps)
    bf = bound(*window_work(bw, n, h, 32, False), PEAK_BF16)
    bb = bound(*window_work(bw, n, h, 32, True), PEAK_BF16)
    tolerance = f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)"
    common = dict(stage=label, shape=shape, tolerance=tolerance)
    entries = [dict(name="window_attention_fwd", **common, max_abs_err=err_fwd,
                    ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms,
                    bound_ms=bf[0], bound_by=bf[1], library_ms=lib_fwd_ms,
                    library_call="F.scaled_dot_product_attention, float attn_mask"),
               dict(name="window_attention_bwd", **common, max_abs_err=err_bwd,
                    ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_all_ms - plain_fwd_ms,
                    bound_ms=bb[0], bound_by=bb[1], library_ms=lib_all_ms - lib_fwd_ms,
                    library_call="F.scaled_dot_product_attention (forward+backward) "
                                 "- forward, float attn_mask")]
    log(f"window attention {label}: fwd {fwd_ms:.4f} ms (bound {bf[0]:.4f}, plain "
        f"{plain_fwd_ms:.3f}, SDPA {lib_fwd_ms:.4f}), bwd {bwd_ms:.4f} ms (bound "
        f"{bb[0]:.4f}, plain {plain_all_ms - plain_fwd_ms:.3f}, SDPA "
        f"{lib_all_ms - lib_fwd_ms:.4f}); max abs err {err_fwd:.3e} / {err_bwd:.3e}")
    del qkv, g, qkvn, rn, mask, sl, pleaves
    torch.cuda.empty_cache()
    return entries


# The kernel table. ``check`` names a function of ``CHECKS``, called as
# ``check(label, REPS, *shape)``; it compares its kernels with their plain
# versions and returns one row for each of its kernels. ``net`` names the net
# whose pass gives the shape (``row_launches``). ``group``: "kernels" runs in
# the full run only, "stem", "swin" and "prefix" also alone (``--phase``).
Case = collections.namedtuple("Case", "group check label shape net")


def cases() -> tuple:
    """The table's cases, at the stages of their scripts' nets
    (``recipe_stages``) and at the scripts' batches."""
    tiny, searched = recipe_stages(TINY), recipe_stages(SEARCHED)
    medium, f392 = recipe_stages(MEDIUM), recipe_stages(FINETUNE)
    n392, _, h392, d392 = f392[0]
    return (
        # the Tiny supernet's stages: its train step, a scoring forward, and
        # the kernels no model runs at the same shapes
        *(case for i, (n, c, h, d) in enumerate(tiny) for case in (
            Case("kernels", "attention", f"stage {i + 1}", (BATCH, n, h, d, "packed"), TINY),
            Case("kernels", "attention", f"stage {i + 1}", (BATCH, n, h, d, "separate"), None),
            Case("kernels", "attention", f"stage {i + 1}", (BATCH, n, h, d, "seq_major"), None),
            Case("kernels", "lab", f"stage {i + 1}", (BATCH, n, h, d), None),
            Case("kernels", "masked_ln", f"stage {i + 1}", (BATCH, n, c, True), TINY),
            # K5 takes each masked layer norm's statistics on ln_route="stats"
            Case("kernels", "row_stats", f"stage {i + 1}", (BATCH, n, c), TINY),
            Case("kernels", "attention", f"stage {i + 1}",
                 (SEARCH_BATCH, n, h, d, "packed", "bfloat16", False), TINY_SEARCH),
            Case("kernels", "masked_ln", f"stage {i + 1}", (SEARCH_BATCH, n, c, False),
                 TINY_SEARCH),
            Case("kernels", "row_stats", f"stage {i + 1}", (SEARCH_BATCH, n, c), TINY_SEARCH))),
        # past the supernet's shapes: the 392 px finetune's stage 1 (N = 785,
        # where the bf16 backward takes the split route) in float32 and on
        # the other two layouts, and a head dim of 24
        Case("kernels", "attention", "392px stage 1",
             (FINETUNE_BATCH, n392, h392, d392, "packed", "float32"), FINETUNE),
        *(Case("kernels", "attention", "392px stage 1",
               (FINETUNE_BATCH, n392, h392, d392, layout), None)
          for layout in ("separate", "seq_major")),
        Case("kernels", "attention", "head dim 24", (BATCH, 257, 8, 24, "packed"), None),
        # the dense nets: the searched Tiny net, the 392 px finetune, DeiT-S
        *(Case("kernels", "attention", f"searched stage {i + 1}", (BATCH, n, h, d, "packed"),
               SEARCHED) for i, (n, _, h, d) in enumerate(searched)),
        *(Case("kernels", "attention", f"392px stage {i + 1}",
               (FINETUNE_BATCH, n, h, d, "packed"), FINETUNE)
          for i, (n, _, h, d) in enumerate(f392)),
        Case("kernels", "attention", "DeiT-S", (BATCH, 198, 6, 64, "packed"), "DeiT-S"),
        *(Case("kernels", "layer_norm", f"Medium stage {i + 1}", (script_batch(MEDIUM), n, c),
               MEDIUM) for i, (n, c, _, _) in enumerate(medium)),
        *(Case("kernels", "layer_norm", f"392px stage {i + 1}", (script_batch(FINETUNE), n, c),
               FINETUNE) for i, (n, c, _, _) in enumerate(f392)),
        # the supernet's masks and drop path at the Tiny stages, drop path
        # alone at Medium's first
        *(Case("prefix", "prefix_mask", f"stage {i + 1}",
               (BATCH, st["N"], st["C"], st["H"] * st["D"], st["F"], True), TINY)
          for i, st in enumerate(net_stages(*recipe_net(TINY)[:2]))),
        *(Case("prefix", "prefix_mask", "Medium stage 1",
               (script_batch(MEDIUM), st["N"], st["C"], st["H"] * st["D"], st["F"], False),
               MEDIUM) for st in net_stages(*recipe_net(MEDIUM)[:2])[:1]),
        # the conv stem's batch norm with its ReLU at the cells' stem shapes,
        # then the whole stem module
        Case("stem", "stem_norm", "train 224px", (script_batch(TINY), 224, True), TINY),
        Case("stem", "stem_norm", "train 392px", (script_batch(FINETUNE), 392, True), FINETUNE),
        Case("stem", "stem_norm", "eval 224px", (SEARCH_BATCH, 224, False), TINY_SEARCH),
        Case("stem", "stem_module", "train 224px", (script_batch(TINY), 224), TINY),
        # SwinV2-B's windowed attention
        *(Case("swin", "window_attention",
               f"SwinV2-B stage {1 + [64, 32, 16, 8].index(r)}" + (" shifted" if shift else ""),
               (bw, n, h, shift, r), "SwinV2-B") for bw, n, h, shift, r in SWIN_STAGES),
    )


# the function of each case's ``check`` (``cases``)
CHECKS = {"attention": check_attention, "masked_ln": check_masked_ln,
          "row_stats": check_row_stats, "lab": check_lab, "layer_norm": check_layer_norm,
          "stem_norm": check_stem_norm, "stem_module": stem_module,
          "window_attention": check_window_attention, "prefix_mask": check_prefix_mask}


def row_launches(row: dict, scripts: dict):
    """A row's kernel launches as the recipes phase counted them in the run
    of the row's net (``scripts``: its runs by script), with that run's
    train steps and eval or scoring forwards; None where no run of this
    process counted them."""
    run = scripts.get(row["net"])
    if run is None or row["name"] not in run["launches"]:
        return None
    return {"count": run["launches"][row["name"]], "steps": run["steps"],
            "forwards": run["forwards"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="directory for the full JSON report")
    parser.add_argument("--phase", choices=("all", "swin", "stem", "prefix"), default="all",
                        help="the whole table and the recipes, or only the table's SwinV2, "
                             "conv stem or prefix-mask cases (after the build)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available; nothing was run")
        return 2
    sys.path.insert(0, HERE)
    from vit_search_torch.ops import attention, kernels, masked_layer_norm, stats  # noqa: F401
    from vit_search_torch.ops import batch_norm, window_attention  # noqa: F401
    from vit_search_torch.tools import attn_lab  # noqa: F401

    card = card_line()
    print(card, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(reports)} in {build_s:.1f} s")
    report = {"card": card, "kind": kind, "count": count, "build_s": build_s,
              "ptxas": reports}
    report["masked_ln_registers"] = regs = ptxas_summary(reports.get("masked_ln", ""),
                                                         "masked_ln_")
    log("K3/K4 registers (ptxas): " + "; ".join(
        f"{r['kernel']} {r['registers']} regs, spills {r['spill_stores']}/{r['spill_loads']} B"
        for r in regs))

    if args.phase == "all":
        # K2's routes at the recipes' shapes by kernel name, in the process's
        # first profiler session
        report["recipe_k2_routes"] = k2_routes = recipe_k2_routes()
        log(f"K2's routes at the recipes' shapes by kernel name: {k2_routes}")
        # the recipes' image folder, made on the host while the card runs the
        # table
        scratch = tempfile.mkdtemp(prefix="chip_smoke_")
        folder = os.path.join(scratch, "synthfolder")
        maker, folder_s = start_folder(folder)
        atexit.register(stop, maker, scratch)

    entries, scripts = [], {}
    t0 = time.perf_counter()
    for case in cases():
        if args.phase in ("all", case.group):
            entries += [dict(e, net=case.net)
                        for e in CHECKS[case.check](case.label, REPS, *case.shape)]
    log(f"{len(entries)} rows of the table agree with their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    if args.phase == "all":
        try:
            t0 = time.perf_counter()
            maker.join()
            if maker.exitcode != 0:
                raise AssertionError(f"make_folder: exit {maker.exitcode}")
            report["folder_s"], report["folder_wait_s"] = (folder_s.value,
                                                           time.perf_counter() - t0)
            log(f"folder made in {folder_s.value:.1f} s beside the table; waited "
                f"{report['folder_wait_s']:.1f} s for it")
            torch.cuda.empty_cache()   # the card's memory to the recipes' runs
            report["recipes"] = rc = recipes(folder, scratch)
            scripts = rc["scripts"]
            slowest = max(rc["scripts"].items(), key=lambda kv: kv[1]["peak_bytes"])
            print(f"recipes: {len(rc['scripts'])} published scripts chained through the "
                  f"port's CLIs in {rc['seconds']:.1f} s, each at its own batch"
                  + "".join(f", {s} at {b} (cut)" for s, b in RECIPE_BATCH_CUTS.items())
                  + f"; the largest peak {slowest[1]['peak_bytes'] / 2**30:.2f} GiB "
                  f"({slowest[0]}) on {card}", flush=True)
        finally:
            stop(maker, scratch)
        # the kernels at the recipes' shapes, and one profiled step of the
        # Small supernet from device batches
        t0 = time.perf_counter()
        entries += check_recipe_kernels(REPS, k2_routes)
        log(f"K1-K4 agree with their plain versions at the recipes' shapes "
            f"({time.perf_counter() - t0:.1f} s)")
        report["recipe_profile"] = pr = recipe_profile(RECIPE_KERNEL_SCRIPTS[0][1], 2, 1)
        prof = pr["profiled_step"]
        print(f"{RECIPE_KERNEL_SCRIPTS[0][1]} step from device batches: "
              f"{pr['imgs_per_s']:.1f} imgs/s ({pr['step_ms']:.1f} ms/step, batch "
              f"{pr['batch']}) peak memory {pr['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
              f"profiled step {prof['device_busy_ms']:.1f} ms busy of {prof['wall_ms']:.1f} ms "
              f"on {card}", flush=True)
        k4_launches(entries, REPS)

    by_name = {k.name: k for k in kernels.KERNELS}
    for e in entries:
        if e["name"] in by_name:
            e.update(source=by_name[e["name"]].source, replaces=by_name[e["name"]].replaces)
        e.update(batch=e["shape"]["B"], launches=row_launches(e, scripts))
    report["kernels"] = entries
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = "chip_smoke.json" if args.phase == "all" else f"chip_smoke_{args.phase}.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(report, f, indent=1)
    keys = ("name", "stage", "batch", "source", "replaces", "net", "launches",
            "max_abs_err", "tolerance", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the lab's rows also carry their error against K1's / K2's plain function
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys},
                                   **({"err_vs_base": e["err_vs_base"]}
                                      if "err_vs_base" in e else {})} for e in entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
