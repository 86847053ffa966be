#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card (an H100).

    python3 chip_smoke.py [--out DIR]

Phases, each fatal on failure (non-zero exit, no result line):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the hand-written kernels from ``vit_search_torch/csrc`` (nvcc, sm_90a);
3. every kernel against its plain PyTorch version at the three stage shapes
   of the ViT-ResNAS-Tiny supernet at batch 512, with stated tolerances, and
   timed with CUDA events beside its bound and PyTorch's own call;
4. a small conv-stem supernet: the port's forward and one train step on the
   card (kernels) against the same on the CPU (plain versions), in float32;
5. train: the full-width ``SUPERNET_SR_TINY_MH`` supernet at 224px, batch
   512, 32 examples per architecture, token mixup, drop_path 0.2, tanh GELU,
   bf16 compute, AdamW; every loss finite, and each kernel's launch count
   moves by exactly its per-step count;
6. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. It exits non-zero when no CUDA device is
available, and when it stands alone without the repository.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

BATCH = 512
EXAMPLE_PER_ARCH = 32
STEPS, WARMUP = 5, 2      # timed and untimed train steps
REPS = 10                 # timed launches per kernel
# (tokens N, embed C, heads H, head_dim D) of the three stages at 224px
STAGES = ((257, 256, 6, 32), (65, 512, 12, 48), (17, 1024, 12, 64))
# per-step launches on the main path: 3 stages x 6 blocks of attention;
# masked LN twice per block, once per SR block (2), once final
PER_STEP = {"attention_qkv_fwd": 18, "attention_qkv_bwd": 18,
            "masked_layer_norm_fwd": 39, "masked_layer_norm_bwd": 39}
# H100 SXM data sheet: HBM bytes/s; dense bf16 tensor-core and f32 flop/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# tolerance: |kernel - plain| <= ATOL * max|plain| + RTOL * |plain|
BF16_TOL = (2e-2, 2e-2)
F32_SUM_TOL = (1e-3, 1e-3)   # gw/gb: the order of the sum differs
STATS_TOL = (1e-4, 1e-4)


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


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_attention(stage: int, reps: int):
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import attention as A

    n, _, h, d = STAGES[stage]
    b, w = BATCH, h * d
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(stage)
    qkv = torch.randn(b, n, 3 * w, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(b, n, w, device="cuda", generator=gen).to(torch.bfloat16)

    # through autograd: the forward launches K1, the backward K2
    leaf = qkv.clone().requires_grad_()
    out = A.fused_attention_qkv(leaf, scale, h)
    (dqkv,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    ref_out = A.attention_qkv_plain(qkv, scale, h)
    ref_dqkv = A.attention_qkv_bwd_plain(qkv, do, scale, h)
    err_fwd = compare(f"K1 stage {stage + 1}", out, ref_out, BF16_TOL)
    err_bwd = compare(f"K2 stage {stage + 1}", dqkv, ref_dqkv, BF16_TOL)

    fwd_ms = time_ms(lambda: A.attention_qkv_fwd_cuda(qkv, scale, h), reps)
    bwd_ms = time_ms(lambda: A.attention_qkv_bwd_cuda(qkv, do, scale, h), reps)
    plain_fwd_ms = time_ms(lambda: A.attention_qkv_plain(qkv, scale, h), reps)
    plain_bwd_ms = time_ms(lambda: A.attention_qkv_bwd_plain(qkv, do, scale, h), reps)

    # PyTorch's own attention on the same tensors, as a yardstick only
    sleaf = qkv.clone().requires_grad_()
    q, k, v = sleaf.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    do_bhnd = do.view(b, n, h, d).transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), sleaf, do_bhnd)

    with torch.no_grad():
        lib_fwd_ms = time_ms(sdpa, reps)
    lib_fwd_bwd_ms = time_ms(sdpa_fwd_bwd, reps)

    flops_fwd = 4.0 * b * h * n * n * d
    flops_bwd = 10.0 * b * h * n * n * d
    bfwd = bound(nbytes(qkv, ref_out), flops_fwd, PEAK_BF16)
    bbwd = bound(nbytes(qkv, do, ref_dqkv), flops_bwd, PEAK_BF16)
    shape = {"B": b, "N": n, "H": h, "D": d, "dtype": "bfloat16"}
    return [
        dict(name="attention_qkv_fwd", stage=stage + 1, shape=shape, max_abs_err=err_fwd,
             tolerance=f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)",
             ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0], bound_by=bfwd[1],
             library_ms=lib_fwd_ms,
             library_call="F.scaled_dot_product_attention forward"),
        dict(name="attention_qkv_bwd", stage=stage + 1, shape=shape, max_abs_err=err_bwd,
             tolerance=f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)",
             ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bbwd[0], bound_by=bbwd[1],
             library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
             library_call="F.scaled_dot_product_attention (forward+backward) - forward"),
    ]


def check_masked_ln(stage: int, reps: int):
    import numpy as np
    import torch
    from vit_search_torch.ops import masked_layer_norm as M
    from vit_search_torch.ops.masking import make_channel_mask

    n, c, _, _ = STAGES[stage]
    b = BATCH
    gen = torch.Generator(device="cuda").manual_seed(100 + stage)
    widths = np.array([c, c * 7 // 8, c * 3 // 4, c * 11 // 16, c * 5 // 8])
    counts = torch.as_tensor(np.random.default_rng(stage).choice(widths, b), device="cuda")
    mask = make_channel_mask(counts, c, dtype=torch.bfloat16)
    x = (torch.randn(b, n, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16) * mask
    g = torch.randn(b, n, c, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)

    y, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
    gx, gw, gb = M.masked_ln_bwd_cuda(x, mask, w, stats, g)
    torch.cuda.synchronize()
    ref_y, ref_stats = M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6)
    ref_gx, ref_gw, ref_gb = M.masked_ln_bwd_plain(x, mask, w, ref_stats, g)
    err_fwd = max(compare(f"K3 y stage {stage + 1}", y, ref_y, BF16_TOL),
                  compare(f"K3 stats stage {stage + 1}", stats, ref_stats, STATS_TOL))
    err_bwd = compare(f"K4 gx stage {stage + 1}", gx, ref_gx, BF16_TOL)
    err_sum = max(compare(f"K4 gw stage {stage + 1}", gw, ref_gw, F32_SUM_TOL),
                  compare(f"K4 gb stage {stage + 1}", gb, ref_gb, F32_SUM_TOL))

    fwd_ms = time_ms(lambda: M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6), reps)
    bwd_ms = time_ms(lambda: M.masked_ln_bwd_cuda(x, mask, w, stats, g), reps)
    plain_fwd_ms = time_ms(lambda: M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6), reps)
    plain_bwd_ms = time_ms(lambda: M.masked_ln_bwd_plain(x, mask, w, stats, g), reps)

    bfwd = bound(nbytes(x, mask, w, bias, ref_y, ref_stats), 10.0 * x.numel(), PEAK_F32)
    bbwd = bound(nbytes(x, mask, w, ref_stats, g, ref_gx, ref_gw, ref_gb),
                 14.0 * x.numel(), PEAK_F32)
    shape = {"B": b, "N": n, "C": c, "dtype": "bfloat16"}
    return [
        dict(name="masked_layer_norm_fwd", stage=stage + 1, shape=shape, max_abs_err=err_fwd,
             tolerance=(f"y: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                        f"stats: {STATS_TOL}"),
             ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0], bound_by=bfwd[1],
             library_ms=None),
        dict(name="masked_layer_norm_bwd", stage=stage + 1, shape=shape,
             max_abs_err=err_bwd, max_abs_err_gw_gb=err_sum,
             tolerance=(f"gx: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                        f"gw/gb: {F32_SUM_TOL}"),
             ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bbwd[0], bound_by=bbwd[1],
             library_ms=None),
    ]


def check_reference_net():
    """A small conv-stem supernet, float32: card (kernels) vs CPU (plain)."""
    import numpy as np
    import torch
    from vit_search_torch.models import SupernetSchedules, build_arch_masks, create_model
    from vit_search_torch.train import (OptimConfig, StepDraws, TrainConfig, lr_schedule,
                                        make_optimizer, make_train_step)
    from vit_search_torch.data.mixup import sample_token_mix_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = ((4, 64),
           (1, (64, 4, 16), (64, 128), 1), (1, (64, 4, 16), (64, 128), 1),
           (3, 64, 128),
           (1, (128, 4, 32), (128, 256), 1),
           (3, 128, 256),
           (1, (256, 4, 64), (256, 512), 1),
           (2, 256, 10))
    space = [np.array([64, 48]),
             {"attn": np.array([64, 32]), "mlp": np.array([128, 96]), "layer": None},
             {"attn": np.array([64, 32]), "mlp": np.array([128, 96]),
              "layer": np.array([64, 0])},
             np.array([128, 96]),
             {"attn": np.array([128, 64]), "mlp": np.array([256, 192]), "layer": None},
             np.array([256, 192]),
             {"attn": np.array([256, 128]), "mlp": np.array([512, 256]), "layer": None},
             None]
    batch, img = 8, 112
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (batch, img, img, 3), dtype=np.uint8))
    labels = torch.as_tensor(rng.integers(0, 10, batch))
    sched = SupernetSchedules(net, space, example_per_arch=2, num_warmup_epochs=0)
    counts = sched.sample_packed(rng, batch)
    draws = StepDraws(mix=sample_token_mix_draws(rng, batch, 2),
                      drop_keeps=[torch.as_tensor(rng.random(batch) < 0.9) for _ in range(8)])
    results = {}
    for dev in ("cpu", "cuda"):
        model = create_model("flexible_vit_sr_patch14_224_patch_output_supernet",
                             network_def=net, img_size=img, drop_path_rate=0.1,
                             gelu="tanh", device=dev, seed=0)
        masks = build_arch_masks(sched.unpack(counts, batch), net, batch, device=dev)
        x = torch.randn(batch, img, img, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        cls, patch = model(x, masks, patch_output_type="seq",
                           drop_keeps=[k.to(dev) for k in draws.drop_keeps])
        ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=1, global_batch_size=batch)
        step = make_train_step(model, make_optimizer(ocfg, model),
                               TrainConfig(num_classes=10, mixup_mode="token", patch_len=2),
                               schedule=lr_schedule(ocfg), counts_unpack=sched.unpack,
                               device=dev)
        dev_draws = StepDraws(mix=draws.mix,
                              drop_keeps=[k.to(dev) for k in draws.drop_keeps])
        metrics = step(images.to(dev), labels.to(dev), counts, draws=dev_draws)
        results[dev] = (cls.detach().cpu(), patch.detach().cpu(), float(metrics["loss"]),
                        float(metrics["grad_norm"]),
                        {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (c0, p0, l0, g0, sd0), (c1, p1, l1, g1, sd1) = results["cpu"], results["cuda"]
    errs = {"cls_logits": compare("ref net cls logits", c1, c0, (1e-3, 1e-3)),
            "patch_logits": compare("ref net patch logits", p1, p0, (1e-3, 1e-3))}
    for name, a, b_ in (("loss", l1, l0), ("grad_norm", g1, g0)):
        if not math.isclose(a, b_, rel_tol=1e-4):
            raise AssertionError(f"ref net {name}: card {a} vs CPU {b_}")
        errs[name] = abs(a - b_)
    # AdamW's first step moves each parameter by about lr whatever the
    # gradient's size, so parameters are held to an absolute floor
    errs["params_after_step"] = max(compare(f"ref net {k}", sd1[k], sd0[k], (1e-4, 1e-4),
                                            floor=1e-6) for k in sd0)
    return errs


def train(steps: int, warmup: int):
    import numpy as np
    import torch
    from vit_search_torch.arch import presets, spaces
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.ops import kernels
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule,
                                        make_optimizer, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    net = presets.SUPERNET_SR_TINY_MH
    model = create_model("flexible_vit_sr_patch14_224_patch_output_supernet",
                         network_def=net, dtype=torch.bfloat16, drop_path_rate=0.2,
                         gelu="tanh", seed=0)
    ocfg = OptimConfig(base_lr=5e-4, warmup_epochs=5, epochs=120, steps_per_epoch=1000,
                       global_batch_size=BATCH)
    sched = SupernetSchedules(net, spaces.get_space("sr_tiny_mh"),
                              example_per_arch=EXAMPLE_PER_ARCH, num_warmup_epochs=0,
                              arch_mode="multi")
    step = make_train_step(model, make_optimizer(ocfg, model),
                           TrainConfig(num_classes=1000, mixup_mode="token", patch_len=4),
                           schedule=lr_schedule(ocfg), counts_unpack=sched.unpack, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (BATCH, 224, 224, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    labels = torch.randint(0, 1000, (BATCH,), device="cuda", generator=gen)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    warm = [step(images, labels, sched.sample_packed(rng, BATCH)) for _ in range(warmup)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = [step(images, labels, sched.sample_packed(rng, BATCH)) for _ in range(steps)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}

    losses = [float(m["loss"]) for m in warm + metrics]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for name, per_step in PER_STEP.items():
        if launches[name] != per_step * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in {steps} steps, "
                                 f"expected {per_step} per step")
    return {"steps": steps, "warmup_steps": warmup, "batch": BATCH,
            "imgs_per_s": BATCH * steps / elapsed, "step_ms": 1e3 * elapsed / steps,
            "warmup_s": warm_s, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in warm + metrics],
            "launches": launches}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="directory for the full JSON report")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available; nothing was run")
        return 2
    sys.path.insert(0, HERE)
    from vit_search_torch.ops import kernels

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

    entries = []
    for stage in range(len(STAGES)):
        entries += check_attention(stage, REPS)
        entries += check_masked_ln(stage, REPS)
        log(f"stage {stage + 1} kernels agree with their plain versions")
    report["reference_net"] = check_reference_net()
    log(f"reference net: card vs CPU {report['reference_net']}")

    report["train"] = tr = train(STEPS, WARMUP)
    print(f"train: {tr['imgs_per_s']:.1f} imgs/s ({tr['step_ms']:.1f} ms/step, batch "
          f"{BATCH}) peak memory {tr['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
          f"on {card}", flush=True)
    by_name = {k.name: k for k in kernels.KERNELS}
    for e in entries:
        k = by_name[e["name"]]
        e.update(route="cuda", source=k.source, replaces=k.replaces,
                 launches=tr["launches"][e["name"]],
                 launches_per_step=PER_STEP[e["name"]], kernel_ms=e["ms"])
    report["kernels"] = entries
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    keys = ("name", "stage", "route", "source", "replaces", "launches", "launches_per_step",
            "max_abs_err", "tolerance", "ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
