"""Train cells: a published recipe's train step on one card, from batches
resident on the device.

Set-up builds the step through the port's public API with the arguments its
training CLI derives from the recipe's flags (``mixes/<mix>.json``), loads
weights made from the seed into the model by their state-dict names, puts
the step at the mix's epoch, and drives it through the checked steps: rows
that all differ, the random draws made from the seed and handed in, each
step's loss, the first gradient as AdamW holds it, and the parameters' (and
the EMA's) change after the last checked step kept. One more step warms the
window's own call. The window then runs the CLI's loop (keep counts drawn
on the host, the step, the losses read back every ``drain_every`` steps)
until ``--seconds`` have passed, ends in ``torch.cuda.synchronize()``, and
the rate is every image over all of that time. After the window the
program's state is freed and the reference repeats the checked steps.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np

from benchlib import compare, cost, device as dev, draws as D, shapes
from benchlib.harness import log
from reference import model as ref_model, train as ref_train

SPANS = ("bench.sample_counts", "bench.train_step", "bench.drain")
GIB = 2.0 ** 30


def program_draws(d: D.StepDraws):
    """The port's form of one step's draws."""
    from vit_search_torch.data.erasing import ErasingDraws
    from vit_search_torch.data.mixup import ImageMixDraws, PatchMixDraws, TokenMixDraws
    from vit_search_torch.train.engine import StepDraws

    y0, x0, h, w = d.box
    erasing = ErasingDraws(apply=d.erase, regions=np.ones(len(d.erase), np.int64),
                           boxes=d.boxes[:, None, :], fill=d.fill[None])
    return StepDraws(mix=TokenMixDraws(PatchMixDraws(d.perm1, y0, x0, h, w),
                                       ImageMixDraws(d.perm2, d.lam)),
                     drop_keeps=list(d.keeps), erasing=erasing)


def build(run):
    """The step as ``cli/train.py`` builds it from the mix's flags:
    ``(step, schedules or None, named parameters, their shapes)``."""
    import torch
    from vit_search_torch import arch, models, train
    from vit_search_torch.models.supernet import SupernetSchedules

    f, cfg = run.mix["flags"], run.config
    net = shapes.to_tuple(cfg["network_def"])
    model = models.create_model(
        f["model"], num_classes=cfg["num_classes"],
        dtype=torch.bfloat16 if f["bf16"] else torch.float32, dropout_rate=f["drop"],
        drop_path_rate=f["drop_path"], img_size=f["input_size"], gelu=f["gelu"],
        seed=run.seed % 2**63, device=run.device, network_def=net)
    named = dict(model.named_parameters())
    leaf_shapes = {n: tuple(p.shape) for n, p in named.items()}
    weights = D.make_weights(leaf_shapes, run.seed, run.device)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(weights[n])
    del weights
    schedules = None
    if models.is_supernet_model(f["model"]):
        schedules = SupernetSchedules(net, arch.get_space(cfg["search_space"]),
                                      example_per_arch=f["example_per_arch"],
                                      num_warmup_epochs=f["num_warmup_epochs"],
                                      arch_mode="multi")
        schedules.set_epoch(run.mix["epoch"])
    batch = f["batch_size"]
    ocfg = train.OptimConfig(
        base_lr=f["lr"], min_lr=f["min_lr"], warmup_lr=f["warmup_lr"],
        warmup_epochs=f["warmup_epochs"], epochs=f["epochs"], weight_decay=f["weight_decay"],
        clip_grad=f["clip_grad"], global_batch_size=batch,
        steps_per_epoch=steps_per_epoch(run), beta1=0.9, beta2=0.999, eps=f["opt_eps"],
        lr_noise=None, seed=run.seed, sched=f["sched"])
    optimizer = train.make_optimizer(ocfg, model)
    tcfg = train.TrainConfig(
        num_classes=cfg["num_classes"], smoothing=f["smoothing"], mixup_mode="token",
        mixup_alpha=f["mixup"], cutmix_alpha=f["cutmix"],
        mixup_switch_prob=f["mixup_switch_prob"], mixup_prob=f["mixup_prob"],
        mixup_elem_mode=f["mixup_mode"], patch_len=f["mixup_patch_len"],
        ema_decay=f["model_ema_decay"] if f["model_ema"] else None,
        erasing_prob=f["reprob"], erasing_mode=f["remode"], erasing_count=f["recount"])
    step = train.make_train_step(
        model, optimizer, tcfg, schedule=train.lr_schedule(ocfg),
        counts_unpack=schedules.unpack if schedules is not None else None,
        seed=run.seed % 2**63, device=run.device)
    step.state.step = run.mix["epoch"] * steps_per_epoch(run)
    return step, schedules, named, leaf_shapes


def steps_per_epoch(run) -> int:
    return run.mix["train_images"] // run.mix["flags"]["batch_size"]


def draw_rates(run) -> List[float]:
    f = run.mix["flags"]
    return ref_model.drop_path_draws(shapes.to_tuple(run.config["network_def"]), f["drop_path"])


def step_draws(run, index: int) -> D.StepDraws:
    f = run.mix["flags"]
    return D.make_step_draws(run.seed, index, f["batch_size"], f["input_size"],
                             f["mixup_patch_len"], f["reprob"], draw_rates(run), run.device)


def to_host(tensors: Dict) -> Dict:
    return {n: t.detach().float().cpu() for n, t in tensors.items()}


def checked_steps(run, step, schedules, named, images, labels, host_rng):
    """Drive the step through the checked steps; what the comparison needs."""
    import torch

    f, n = run.mix["flags"], run.mix["check_steps"]
    losses, packed_counts, grads = [], [], None
    for k in range(n):
        packed = (schedules.sample_packed(host_rng, f["batch_size"])
                  if schedules is not None else None)
        packed_counts.append(packed)
        out = step(images[k], labels[k], packed, draws=program_draws(step_draws(run, k)))
        losses.append(out["loss"])
        if k == 0:
            # AdamW's first moment after one step is (1 - beta1) x the gradient
            # (nothing where it took no step)
            state = step.optimizer.state
            grads = to_host({name: state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - 0.9)
                             for name, p in named.items()})
    p0 = D.make_weights({name: p.shape for name, p in named.items()}, run.seed, run.device)
    got = {"losses": [float(v) for v in losses], "grads": grads,
           "change": to_host({name: p.detach() - p0[name] for name, p in named.items()}),
           "ema_change": None}
    if step.state.ema_params is not None:
        got["ema_change"] = to_host({name: e - p0[name]
                                     for name, e in step.state.ema_params.items()})
    del p0
    return got, packed_counts


def window(run, step, schedules, images, labels, host_rng, k0: int, seconds: float = 0.0,
           count: int = 1):
    """The CLI's step loop over the resident batches, for ``seconds`` or for
    ``count`` steps, whichever is more: ``(steps, elapsed seconds, losses
    read back)``."""
    import torch
    from torch.profiler import record_function

    f = run.mix["flags"]
    pool, drain_every = images.shape[0], run.mix["drain_every"]
    pending, losses, steps = [], [], 0
    t0 = time.perf_counter()
    while True:
        k = k0 + steps
        with record_function("bench.sample_counts"):
            packed = (schedules.sample_packed(host_rng, f["batch_size"])
                      if schedules is not None else None)
        with record_function("bench.train_step"):
            pending.append(step(images[k % pool], labels[k % pool], packed)["loss"])
        steps += 1
        done = steps >= count and time.perf_counter() - t0 >= seconds
        if len(pending) >= drain_every or done:
            with record_function("bench.drain"):
                losses += torch.stack([v.float() for v in pending]).cpu().tolist()
            pending = []
        if done:
            break
    if run.device == "cuda":
        torch.cuda.synchronize()
    return steps, time.perf_counter() - t0, losses


def profiled(run, step, schedules, images, labels, host_rng, step_seconds: float, k0: int):
    """A few more steps of the same loop under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = int(min(10, max(3, math.ceil(2.0 / max(step_seconds, 1e-3)))))
    if run.device == "cuda":
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(run, step, schedules, images, labels, host_rng, k0, count=n)
    return dev.reduce_trace(prof.events(), SPANS)


def run(run) -> Dict:
    import torch

    f, cfg = run.mix["flags"], run.config
    batch, size = f["batch_size"], f["input_size"]
    net = shapes.to_tuple(cfg["network_def"])
    log(run, "building the step")
    step, schedules, named, leaf_shapes = build(run)
    images, labels = D.make_images(run.seed, run.mix["resident_batches"], batch, size,
                                   cfg["num_classes"], run.device)
    host_rng = np.random.default_rng((run.seed % 2**63, run.mix["epoch"]))
    log(run, "checked steps")
    got, packed_counts = checked_steps(run, step, schedules, named, images, labels, host_rng)
    n_check = run.mix["check_steps"]
    log(run, "warm step")
    window(run, step, schedules, images, labels, host_rng, n_check)   # the window's call, warm
    setup_s = time.perf_counter() - run.t_start
    log(run, "window")

    steps, elapsed, losses = window(run, step, schedules, images, labels, host_rng,
                                    n_check + 1, seconds=run.seconds)
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
    macs = cost.macs(net, size)
    log(run, f"{steps} steps of {batch} in {elapsed:.3f} s, {imgs_per_s:.1f} imgs/s, "
             f"peak {peak / GIB:.2f} GiB, set-up {setup_s:.1f} s")
    if run.trace:
        trace = profiled(run, step, schedules, images, labels, host_rng, elapsed / steps,
                         n_check + 1 + steps)
        result["device"].update(busy_s=trace.get("busy_s", 0.0),
                                window_s=trace.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": trace.get("device_ops", []),
                               "idle_gaps": trace.get("idle_gaps", [])}
        space = cfg.get("space")
        result["ctx"] = {
            "run": run, "imgs_per_s": imgs_per_s, "macs_per_image": macs, "trace": trace,
            "attention_calls": shapes.attention_calls(net, size, batch),
            "masked_ln_calls": (shapes.masked_ln_calls(net, space, size, batch)
                                if schedules is not None else []),
            "example_per_arch": f.get("example_per_arch")}

    # the program's state goes before the reference runs
    del step, named
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(run, "reference")
    p0 = D.make_weights(leaf_shapes, run.seed, run.device)
    batches = [(images[k], labels[k], packed_counts[k], step_draws(run, k))
               for k in range(n_check)]
    ref = ref_train.run_steps(p0, batches, f, net, cfg.get("space"), cfg["num_classes"],
                              run.mix["epoch"] * steps_per_epoch(run), steps_per_epoch(run))
    log(run, f"losses {got['losses']} against {ref['losses']}")
    numbers = compare.train_numbers(got, ref)
    log(run, "numbers " + ", ".join(f"{k} {v:.4g} at {w}" for k, (v, w) in numbers.items()))
    correct, checks = compare.judge(numbers, run.limits["limits"])
    result.update(correct=correct and failed == 0, checks=checks)
    return result


def build_shapes_and_counts(run):
    """The leaf shapes and the checked steps' keep counts of the cell's
    step, without running it (a control's inputs)."""
    import torch

    step, schedules, named, leaf_shapes = build(run)
    host_rng = np.random.default_rng((run.seed % 2**63, run.mix["epoch"]))
    batch = run.mix["flags"]["batch_size"]
    packed = [schedules.sample_packed(host_rng, batch) if schedules is not None else None
              for _ in range(run.mix["check_steps"])]
    del step, named
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return leaf_shapes, packed
