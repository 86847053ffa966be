"""The EVA-02 fine-tune cell: EVA-02-L's ImageNet-1k fine-tune at 448 px on
one card of its data-parallel deployment, from batches resident on the
device.

Set-up builds the step through the port's public API (the model by its
registered name, AdamW with layer-wise learning-rate decay and EVA-02's
no-decay leaves, the engine's image-level Mixup/CutMix, erasing and the
EMA), loads weights made from the seed by their state-dict names
(``draws.make_weights``), puts the step at the mix's epoch, and drives it
through the checked steps with the draws handed in (the SwinV2 cell's:
``drivers/swin_train.py``): each step's loss, the first gradient as AdamW
holds it, and the parameters' and the EMA's change after the last checked
step. One more step warms the window's call; the window then runs the
CLI's loop (``drivers/train.py``'s ``window``). A traced run also counts
the rotary attention's and the SwiGLU sub-LN's launches a step, by shape,
for their rooflines. After the window the program's state is freed and the
reference (``reference/eva_train.py``) repeats the checked steps, the batch
in chunks.

The learning rate is that of the deployment's global batch
(``flags.global_batch``): a card of the deployment runs the same step size.
"""

from __future__ import annotations

import gc
import math
import os
import time
from typing import Dict

from benchlib import compare, draws as D, eva, harness
from benchlib.harness import log
from reference import eva02 as ref_eva02, eva_train as ref_eva

GIB = 2.0 ** 30
HERE = os.path.dirname(os.path.abspath(__file__))
# the ViT-ResNAS train cells' driver (its loop) and the SwinV2 cell's (its draws)
base = harness.load_module(os.path.join(HERE, "train.py"), "bench_driver_train")
swin = harness.load_module(os.path.join(HERE, "swin_train.py"), "bench_driver_swin_train")
CFG_KEYS = ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio",
            "num_classes")
KERNELS = {"rope_attention_calls": "rope_attention_fwd", "swiglu_ln_calls": "swiglu_ln_fwd"}


def model_cfg(run) -> Dict:
    return {k: run.config[k] for k in CFG_KEYS}


def steps_per_epoch(run) -> int:
    return run.mix["train_images"] // run.mix["flags"]["global_batch"]


def step_draws(run, index: int):
    """``(erasing and keeps, the Mixup/CutMix draw)`` of checked step ``index``."""
    from benchlib import swin as swin_lib

    f = run.mix["flags"]
    rates = ref_eva02.drop_path_draws(run.config["depth"], f["drop_path"])
    d = D.make_step_draws(run.seed, index, f["batch_size"], f["input_size"], 1, f["reprob"],
                          rates, run.device)
    return d, swin_lib.mix_draw(run.seed, index, f["input_size"], f["mixup"], f["cutmix"],
                                f["mixup_switch_prob"])


def build(run):
    """``(step, named parameters, their shapes)`` as ``cli/train.py`` builds
    them from the mix's flags."""
    import torch
    from vit_search_torch import models, train

    f, cfg = run.mix["flags"], run.config
    model = models.create_model(
        cfg["model"], num_classes=cfg["num_classes"], img_size=f["input_size"],
        dtype=torch.bfloat16 if f["bf16"] else torch.float32, drop_path_rate=f["drop_path"],
        seed=run.seed % 2**63, device=run.device,
        **{k: cfg[k] for k in ("embed_dim", "depth", "num_heads", "mlp_ratio")})
    named = dict(model.named_parameters())
    leaf_shapes = {n: tuple(p.shape) for n, p in named.items()}
    weights = D.make_weights(leaf_shapes, run.seed, run.device)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(weights[n])
    del weights
    ocfg = train.OptimConfig(
        base_lr=f["lr"], min_lr=f["min_lr"], warmup_lr=f["warmup_lr"],
        warmup_epochs=f["warmup_epochs"], epochs=f["epochs"], weight_decay=f["weight_decay"],
        clip_grad=f["clip_grad"], global_batch_size=f["global_batch"],
        steps_per_epoch=steps_per_epoch(run), beta1=0.9, beta2=0.999, eps=f["opt_eps"],
        lr_noise=None, seed=run.seed, sched=f["sched"], layer_decay=f["layer_decay"])
    tcfg = train.TrainConfig(
        num_classes=cfg["num_classes"], smoothing=f["smoothing"], mixup_mode="mixup",
        mixup_alpha=f["mixup"], cutmix_alpha=f["cutmix"],
        mixup_switch_prob=f["mixup_switch_prob"], mixup_prob=f["mixup_prob"],
        mixup_elem_mode=f["mixup_mode"], erasing_prob=f["reprob"], erasing_mode=f["remode"],
        erasing_count=f["recount"], ema_decay=f["model_ema_decay"])
    step = train.make_train_step(model, train.make_optimizer(ocfg, model), tcfg,
                                 schedule=train.lr_schedule(ocfg), seed=run.seed % 2**63,
                                 device=run.device)
    step.state.step = run.mix["epoch"] * steps_per_epoch(run)
    return step, named, leaf_shapes


def checked_steps(run, step, named, images, labels):
    """Drive the step through the checked steps; what the comparison needs."""
    import torch

    losses, grads = [], None
    for k in range(run.mix["check_steps"]):
        out = step(images[k], labels[k], None, draws=swin.program_draws(*step_draws(run, k)))
        losses.append(out["loss"])
        if k == 0:
            state = step.optimizer.state
            grads = base.to_host(
                {name: state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - 0.9)
                 for name, p in named.items()})
    p0 = D.make_weights({name: p.shape for name, p in named.items()}, run.seed, run.device)
    got = {"losses": [float(v) for v in losses], "grads": grads,
           "change": base.to_host({name: p.detach() - p0[name] for name, p in named.items()}),
           "ema_change": base.to_host({name: e - p0[name]
                                       for name, e in step.state.ema_params.items()})}
    del p0
    return got


def reference(run, leaf_shapes, images, labels, **kwargs) -> Dict:
    """The reference's checked steps from the seed's weights."""
    f = run.mix["flags"]
    p0 = D.make_weights(leaf_shapes, run.seed, run.device)
    batches = [(images[k], labels[k], *step_draws(run, k))
               for k in range(run.mix["check_steps"])]
    return ref_eva.run_steps(p0, batches, model_cfg(run), f, run.config["num_classes"],
                             run.mix["epoch"] * steps_per_epoch(run), steps_per_epoch(run),
                             run.mix["reference_chunk"], **kwargs)


def launch_counts():
    """The launch records of the two fused layers, by ctx key (``{}`` for a
    program without them)."""
    from vit_search_torch.ops import kernels

    records = {k.name: k for k in kernels.KERNELS}
    return {key: records[name] for key, name in KERNELS.items() if name in records}


def profiled(run, step, images, labels, step_seconds: float, k0: int):
    """A few more steps of the loop under ``torch.profiler``: the trace's
    reduction, and each fused layer's launches a step with its shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchlib import device as dev

    n = int(min(10, max(3, math.ceil(2.0 / max(step_seconds, 1e-3)))))
    records = launch_counts()
    before = {key: r.launches for key, r in records.items()}
    if run.device == "cuda":
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps, _, _ = base.window(run, step, None, images, labels, None, k0, count=n)
    batch, cfg = run.mix["flags"]["batch_size"], model_cfg(run)
    # the MLP's hidden pitch as the model runs it (its zero padding)
    pad = getattr(step.model.blocks[0].mlp, "pad", 0)
    shapes = {"rope_attention_calls": eva.rope_shape(cfg, batch),
              "swiglu_ln_calls": eva.swiglu_shape(cfg, batch, pad)}
    calls = {key: [(shapes[key], (r.launches - before[key]) / steps)]
             for key, r in records.items() if r.launches > before[key]}
    return dev.reduce_trace(prof.events(), base.SPANS), calls


def run(run) -> Dict:
    import torch

    f, cfg = run.mix["flags"], run.config
    batch, size = f["batch_size"], f["input_size"]
    log(run, "building the step")
    step, named, leaf_shapes = build(run)
    images, labels = D.make_images(run.seed, run.mix["resident_batches"], batch, size,
                                   cfg["num_classes"], run.device)
    log(run, "checked steps")
    got = checked_steps(run, step, named, images, labels)
    n_check = run.mix["check_steps"]
    log(run, "warm step")
    base.window(run, step, None, images, labels, None, n_check)
    setup_s = time.perf_counter() - run.t_start
    log(run, "window")
    steps, elapsed, losses = base.window(run, step, None, images, labels, None, n_check + 1,
                                         seconds=run.seconds)
    imgs_per_s = steps * batch / elapsed
    cuda = run.device == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = sum(1 for v in losses if not math.isfinite(v))
    result = {
        "attempted": steps, "failed": failed,
        "end_to_end": {"train_imgs_per_s": {"value": imgs_per_s, "unit": "imgs/s"},
                       "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
                       "setup_s": {"value": setup_s, "unit": "s"}},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}}
    log(run, f"{steps} steps of {batch} in {elapsed:.3f} s, {imgs_per_s:.1f} imgs/s, "
             f"peak {peak / GIB:.2f} GiB, set-up {setup_s:.1f} s")
    if run.trace:
        trace, calls = profiled(run, step, images, labels, elapsed / steps, n_check + 1 + steps)
        result["device"].update(busy_s=trace.get("busy_s", 0.0),
                                window_s=trace.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": trace.get("device_ops", []),
                               "idle_gaps": trace.get("idle_gaps", [])}
        result["ctx"] = {"run": run, "imgs_per_s": imgs_per_s,
                         "macs_per_image": eva.macs(model_cfg(run), size), "trace": trace,
                         **calls}
        log(run, f"launches a step: {calls}")

    del step, named
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(run, "reference")
    ref = reference(run, leaf_shapes, images, labels)
    log(run, f"losses {got['losses']} against {ref['losses']}")
    numbers = compare.train_numbers(got, ref)
    log(run, "numbers " + ", ".join(f"{k} {v:.4g} at {w}" for k, (v, w) in numbers.items()))
    correct, checks = compare.judge(numbers, run.limits["limits"])
    result.update(correct=correct and failed == 0, checks=checks)
    return result


def build_shapes(run):
    """The leaf shapes of the cell's model, without running it (a control's
    input)."""
    import torch

    step, named, leaf_shapes = build(run)
    del step, named
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return leaf_shapes
