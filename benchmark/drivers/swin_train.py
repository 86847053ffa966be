"""The SwinV2 train cell: Swin's recipe on one card of its data-parallel
deployment, from batches resident on the device.

Set-up builds the step through the port's public API (the model by its
registered name, AdamW with Swin's no-decay leaves, the engine's
image-level Mixup/CutMix, erasing and clipping), loads weights made from
the seed by their state-dict names (``benchlib.swin.make_weights``), puts
the step at the mix's epoch, and drives it through the checked steps with
the draws handed in: each step's loss, the first gradient as AdamW holds it
(clipped), and the parameters' change after the last checked step. One
more step warms the window's call; the window then runs the CLI's loop, as
the ViT-ResNAS train cells' driver does (``drivers/train.py``'s
``window``, whose rate and losses this cell reads the same way). After
the window the program's state is freed and the reference
(``reference/swin_train.py``) repeats the checked steps, the batch in
chunks.

The learning rate is that of the deployment's global batch
(``flags.global_batch``): a card of four runs the same step size.
"""

from __future__ import annotations

import gc
import math
import os
import time
from typing import Dict

import numpy as np

from benchlib import compare, draws as D, harness, swin
from benchlib.harness import log
from reference import swin_train as ref_swin

GIB = 2.0 ** 30
# the ViT-ResNAS train cells' driver, whose loop and helpers this cell shares
base = harness.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "train.py"),
                           "bench_driver_train")
CFG_KEYS = ("img_size", "patch_size", "embed_dim", "depths", "num_heads", "window_size",
            "mlp_ratio", "num_classes")


def model_cfg(run) -> Dict:
    return {k: run.config[k] for k in CFG_KEYS}


def steps_per_epoch(run) -> int:
    return run.mix["train_images"] // run.mix["flags"]["global_batch"]


def draw_rates(run):
    from reference import swinv2
    return swinv2.drop_path_draws(run.config["depths"], run.mix["flags"]["drop_path"])


def step_draws(run, index: int):
    """``(erasing and keeps, the Mixup/CutMix draw)`` of checked step ``index``."""
    f = run.mix["flags"]
    d = D.make_step_draws(run.seed, index, f["batch_size"], f["input_size"], 1, f["reprob"],
                          draw_rates(run), run.device)
    return d, swin.mix_draw(run.seed, index, f["input_size"], f["mixup"], f["cutmix"],
                            f["mixup_switch_prob"])


def program_draws(d, mix):
    """The port's form of one step's draws."""
    from vit_search_torch.data.erasing import ErasingDraws
    from vit_search_torch.data.mixup import MixupDraws
    from vit_search_torch.train.engine import StepDraws

    erasing = ErasingDraws(apply=d.erase, regions=np.ones(len(d.erase), np.int64),
                           boxes=d.boxes[:, None, :], fill=d.fill[None])
    mixup = MixupDraws(np.float32(mix.lam0), mix.use_cutmix, mix.y0, mix.y1, mix.x0, mix.x1)
    return StepDraws(drop_keeps=list(d.keeps), erasing=erasing, mixup=mixup)


def build(run):
    """``(step, named parameters, their shapes)`` as ``cli/train.py`` builds
    them from the mix's flags."""
    import torch
    from vit_search_torch import models, train

    f, cfg = run.mix["flags"], run.config
    model = models.create_model(
        cfg["model"], num_classes=cfg["num_classes"], img_size=f["input_size"],
        dtype=torch.bfloat16 if f["bf16"] else torch.float32, drop_path_rate=f["drop_path"],
        gelu=f["gelu"], seed=run.seed % 2**63, device=run.device,
        **{k: cfg[k] for k in ("embed_dim", "depths", "num_heads", "window_size")})
    named = dict(model.named_parameters())
    leaf_shapes = {n: tuple(p.shape) for n, p in named.items()}
    weights = swin.make_weights(leaf_shapes, run.seed, run.device)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(weights[n])
    del weights
    ocfg = train.OptimConfig(
        base_lr=f["lr"], min_lr=f["min_lr"], warmup_lr=f["warmup_lr"],
        warmup_epochs=f["warmup_epochs"], epochs=f["epochs"], weight_decay=f["weight_decay"],
        clip_grad=f["clip_grad"], global_batch_size=f["global_batch"],
        steps_per_epoch=steps_per_epoch(run), beta1=0.9, beta2=0.999, eps=f["opt_eps"],
        lr_noise=None, seed=run.seed, sched=f["sched"])
    tcfg = train.TrainConfig(
        num_classes=cfg["num_classes"], smoothing=f["smoothing"], mixup_mode="mixup",
        mixup_alpha=f["mixup"], cutmix_alpha=f["cutmix"],
        mixup_switch_prob=f["mixup_switch_prob"], mixup_prob=f["mixup_prob"],
        mixup_elem_mode=f["mixup_mode"], erasing_prob=f["reprob"], erasing_mode=f["remode"],
        erasing_count=f["recount"])
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
        out = step(images[k], labels[k], None, draws=program_draws(*step_draws(run, k)))
        losses.append(out["loss"])
        if k == 0:
            state = step.optimizer.state
            grads = base.to_host(
                {name: state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - 0.9)
                 for name, p in named.items()})
    p0 = swin.make_weights({name: p.shape for name, p in named.items()}, run.seed, run.device)
    got = {"losses": [float(v) for v in losses], "grads": grads,
           "change": base.to_host({name: p.detach() - p0[name] for name, p in named.items()}),
           "ema_change": None}
    del p0
    return got


def reference(run, leaf_shapes, images, labels, **kwargs) -> Dict:
    """The reference's checked steps from the seed's weights."""
    f = run.mix["flags"]
    p0 = swin.make_weights(leaf_shapes, run.seed, run.device)
    batches = [(images[k], labels[k], *step_draws(run, k))
               for k in range(run.mix["check_steps"])]
    return ref_swin.run_steps(p0, batches, model_cfg(run), f, run.config["num_classes"],
                              run.mix["epoch"] * steps_per_epoch(run), steps_per_epoch(run),
                              run.mix["reference_chunk"], **kwargs)


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
        trace, share = profiled(run, step, images, labels, elapsed / steps, n_check + 1 + steps)
        result["device"].update(busy_s=trace.get("busy_s", 0.0),
                                window_s=trace.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": trace.get("device_ops", []),
                               "idle_gaps": trace.get("idle_gaps", [])}
        result["ctx"] = {"run": run, "imgs_per_s": imgs_per_s,
                         "macs_per_image": swin.macs(model_cfg(run), size), "trace": trace,
                         "window_calls": swin.window_calls(model_cfg(run), batch),
                         "rearrange_pct": share}

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


def profiled(run, step, images, labels, step_seconds: float, k0: int):
    """A few more steps of the loop under ``torch.profiler``: the trace's
    reduction and the share of device time under the ``vst.swin.*`` spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchlib import device as dev

    n = int(min(10, max(3, math.ceil(2.0 / max(step_seconds, 1e-3)))))
    if run.device == "cuda":
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        base.window(run, step, None, images, labels, None, k0, count=n)
    events = prof.events()
    return dev.reduce_trace(events, base.SPANS), swin.span_share(events)


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
