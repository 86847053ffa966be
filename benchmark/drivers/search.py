"""Search cells: candidate scoring of a published evolutionary search on one
card, over a held-out sub-val resident on the device.

Set-up makes the sub-val (uint8 images, padded to whole batches of the
recipe's ``--val-bs`` as the port's padded eval loader pads them, the
padding rows weighted 0) and the supernet's weights from the seed, builds
the evaluator, the search's cost model and its evolver through the port's
public API as its search CLI does, and warms one scoring forward. The
window then runs the search's first generation: the evolver's random
population (the host's generator calls), then
``BatchedSupernetEvaluator.score`` on chunks of ``--arch-batch`` candidates
until ``--seconds`` have passed, the chunk running at the deadline
completing. The rate is every candidate-image scored over all of that time.

``correct``: one candidate of the first chunk, drawn from the seed, is
worked out in set-up by the reference (its own weights sliced from the
supernet's, float32, TF32 off), and the sub-val's labels are the
reference's predictions for it, so that its score counts the images on
which the program's prediction agrees with the reference's. An image's
prediction flips where the program's error in its top-two margin exceeds
the margin; with that error normal of spread ``tau``, the expected count of
flips is ``sum_i Phi(-m_i / tau)`` over the reference's margins ``m_i``.
The number compared, ``logit_error``, is the ``tau`` at which that sum
equals the ``D`` images the program disagrees on, over the median spread
of the reference's logits: the program's logit error as its score implies
it, read alike on seeds whose margins lie closer or further apart (the
raw share of flips swings with them). Every scored candidate's
multiply-adds are held to the search's band besides.
"""

from __future__ import annotations

import time
from typing import Dict, List

from benchlib import compare, cost, device as dev, draws as D, shapes
from benchlib.harness import log
from reference import model as ref_model

SPANS = ("bench.gen_candidates", "bench.score_chunk")
GIB = 2.0 ** 30
CHECK = 4
BAND = 0.975


def sub_val(run):
    """``(images (n, B, H, W, 3) uint8, valid (n, B))``: the sub-val in
    batches of the recipe's ``--val-bs``, the last padded by repeating its
    last image, its padding rows invalid."""
    import torch

    f = run.mix["flags"]
    total, bs = run.mix["sub_val_images"], f["val_bs"]
    n = -(-total // bs)
    gen = D.device_generator(run.seed, run.device, D.IMAGES)
    images = torch.randint(0, 256, (total, f["input_size"], f["input_size"], 3),
                           dtype=torch.uint8, device=run.device, generator=gen)
    pad = n * bs - total
    if pad:
        images = torch.cat([images, images[-1:].expand(pad, -1, -1, -1)])
    valid = (torch.arange(n * bs, device=run.device) < total).float()
    return images.view(n, bs, *images.shape[1:]), valid.view(n, bs)


def reference_predictions(run, weights, candidate, images, quant=ref_model.identity):
    """The reference's answer for every sub-val image under ``candidate``, in
    batches, float32 with TF32 off: ``(top-1 class, its margin over the
    second class, the spread of the logits over the classes)``."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sub = ref_model.subnet(weights, candidate)
        mean = torch.tensor(ref_model.MEAN, device=images.device)
        std = torch.tensor(ref_model.STD, device=images.device)
        classes, margins, spreads = [], [], []
        with torch.no_grad():
            for batch in images:
                x = (batch.float() / 255.0 - mean) / std
                logits = ref_model.forward(sub, candidate, x, None, None, 0.0,
                                           patch_output=False, quant=quant, train=False)
                top = logits.topk(2, dim=-1)
                classes.append(top.indices[:, 0])
                margins.append(top.values[:, 0] - top.values[:, 1])
                spreads.append(logits.std(dim=-1))
        return torch.stack(classes), torch.stack(margins), torch.stack(spreads)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def evolver(run):
    from vit_search_torch import arch
    from vit_search_torch.search import PopulationEvolver

    f, cfg = run.mix["flags"], run.config
    net = shapes.to_tuple(cfg["network_def"])
    estimator = arch.ComputationEstimator(distill=False, input_resolution=f["input_size"],
                                          patch_size=cfg["patch_size"])
    return PopulationEvolver(net, arch.get_space(cfg["search_space"]), f["constraint_value"],
                             estimator, seed=run.seed % 2**63)


def checked_candidate(run):
    """``(index in the first chunk, network_def)`` of the checked candidate:
    the first chunk is the first candidates a twin of the window's evolver
    draws."""
    twin = evolver(run)
    twin.random_sample(run.mix["flags"]["arch_batch"])
    index = int(D.host_generator(run.seed, CHECK).integers(len(twin.popu)))
    return index, twin.popu[index].network_def


def build_model(run):
    """The supernet as the search CLI builds it, with weights made from the
    seed (parameters and batch-norm statistics) loaded by name: ``(model,
    the weights)``."""
    import torch
    from vit_search_torch import models

    f, cfg = run.mix["flags"], run.config
    model = models.create_model(f["model"], network_def=shapes.to_tuple(cfg["network_def"]),
                                num_classes=cfg["num_classes"], img_size=f["input_size"],
                                dtype=torch.bfloat16 if f["bf16"] else torch.float32,
                                device=run.device)
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    weights = D.make_weights({n: t.shape for n, t in tensors.items()}, run.seed, run.device)
    with torch.no_grad():
        for n, t in tensors.items():
            t.copy_(weights[n])
    return model, weights


def build(run, model, images, labels, valid):
    """The evaluator over the resident sub-val (its first ``batches``
    batches), as the search CLI builds it."""
    from vit_search_torch import arch
    from vit_search_torch.models.supernet import SupernetSchedules
    from vit_search_torch.search import BatchedSupernetEvaluator

    f, cfg = run.mix["flags"], run.config
    net = shapes.to_tuple(cfg["network_def"])
    schedules = SupernetSchedules(net, arch.get_space(cfg["search_space"]), example_per_arch=1,
                                  num_warmup_epochs=0, arch_mode="multi")
    loader = [(images[i], labels[i], valid[i]) for i in range(images.shape[0])]

    def evaluator(batches=None):
        return BatchedSupernetEvaluator(model, schedules, loader[:batches],
                                        arch_batch=f["arch_batch"], score_head=f["score_head"],
                                        device=run.device)

    return evaluator


def window(run, evaluator, evo, seconds: float):
    """The first generation until ``seconds`` have passed: ``(scored
    (network_def, score) pairs, elapsed seconds)``."""
    from torch.profiler import record_function

    chunk = run.mix["flags"]["arch_batch"]
    t0 = time.perf_counter()
    with record_function("bench.gen_candidates"):
        evo.random_sample(run.mix["flags"]["init_popu_size"])
    defs = [ind.network_def for ind in evo.popu]
    scored = []
    for i in range(0, len(defs), chunk):
        with record_function("bench.score_chunk"):
            scores = evaluator.score(defs[i:i + chunk])
        scored += list(zip(defs[i:i + chunk], scores))
        if time.perf_counter() - t0 >= seconds:
            break
    return scored, time.perf_counter() - t0


def profiled(run, evaluator, defs):
    """One chunk over the first ``profile_batches`` sub-val batches under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = run.device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.score_chunk"):
            evaluator(run.mix["profile_batches"]).score(defs)
        if cuda:
            torch.cuda.synchronize()
    return dev.reduce_trace(prof.events(), SPANS)


def logit_error(disagreeing: int, margins, spreads, valid) -> float:
    """The normal spread ``tau`` of the error in an image's top-two margin
    at which the expected number of flipped valid images is
    ``disagreeing``, over the median spread of their logits (0 where none
    disagrees)."""
    import torch

    keep = valid.flatten() > 0
    scale = float(spreads.flatten()[keep].median())
    m = margins.flatten()[keep].double() / scale
    if disagreeing <= 0:
        return 0.0
    lo, hi = 0.0, 1.0
    while float(torch.special.ndtr(-m / hi).sum()) < disagreeing and hi < 1e6:
        hi *= 2.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if float(torch.special.ndtr(-m / mid).sum()) < disagreeing:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def numbers(run, scored: List, index: int, candidate, reference, valid) -> Dict:
    """The numbers compared: the checked candidate's ``logit_error`` and the
    scored candidates whose multiply-adds lie outside the search's band."""
    f = run.mix["flags"]
    hi = f["constraint_value"]
    out_of_band = sum(1 for net, _ in scored
                      if not BAND * hi <= cost.macs(net, f["input_size"]) <= hi)
    band = (float(out_of_band), "candidates")
    defs = [net for net, _ in scored]
    if len(scored) <= index or defs[index] != candidate:
        return {"logit_error": (float("nan"), "checked candidate not scored"),
                "mac_band_misses": band}
    n_valid = float(valid.sum())
    disagreeing = int(round(n_valid * (1.0 - scored[index][1] / 100.0)))
    _, margins, spreads = reference
    return {"logit_error": (logit_error(disagreeing, margins, spreads, valid),
                             f"candidate {index}, {disagreeing} images"),
            "mac_band_misses": band}


def run(run) -> Dict:
    import torch

    f, cfg = run.mix["flags"], run.config
    cuda = run.device == "cuda"
    log(run, "building the supernet")
    model, weights = build_model(run)
    images, valid = sub_val(run)
    log(run, "the checked candidate's labels")
    index, candidate = checked_candidate(run)
    reference = reference_predictions(run, weights, candidate, images)
    labels = reference[0]
    del weights
    evaluator = build(run, model, images, labels, valid)
    evo = evolver(run)
    n_valid = run.mix["sub_val_images"]
    log(run, "warm forward")
    evaluator(1).score([evo.largest_network_def] * f["arch_batch"])
    setup_s = time.perf_counter() - run.t_start
    log(run, "window")

    scored, elapsed = window(run, evaluator(), evo, run.seconds)
    rate = len(scored) * n_valid / elapsed
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = sum(1 for _, s in scored if not 0.0 <= s <= 100.0)
    log(run, f"{len(scored)} candidates in {elapsed:.3f} s, {rate:.1f} candidate-images/s, "
             f"peak {peak / GIB:.2f} GiB, set-up {setup_s:.1f} s")
    result = {
        "attempted": len(scored), "failed": failed,
        "end_to_end": {"search_cand_imgs_per_s": {"value": rate, "unit": "cand-imgs/s"},
                       "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
                       "setup_s": {"value": setup_s, "unit": "s"}},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}}
    if run.trace:
        defs = [net for net, _ in scored[:f["arch_batch"]]]
        trace = profiled(run, evaluator, defs)
        result["device"].update(busy_s=trace.get("busy_s", 0.0),
                                window_s=trace.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": trace.get("device_ops", []),
                               "idle_gaps": trace.get("idle_gaps", [])}
        net = shapes.to_tuple(cfg["network_def"])
        rows = f["arch_batch"] * f["val_bs"]
        result["ctx"] = {
            "run": run, "trace": trace, "window_s": elapsed, "n_valid": n_valid,
            "scored_macs": sum(cost.macs(d, f["input_size"]) for d, _ in scored),
            "attention_calls": shapes.attention_calls(net, f["input_size"], rows),
            "masked_ln_calls": shapes.masked_ln_calls(net, cfg["space"], f["input_size"], rows),
            "rows_per_candidate": f["val_bs"]}
    got = numbers(run, scored, index, candidate, reference, valid)
    log(run, "numbers " + ", ".join(f"{k} {v:.4g} at {w}" for k, (v, w) in got.items()))
    correct, checks = compare.judge(got, run.limits["limits"])
    result.update(correct=correct and failed == 0, checks=checks)
    return result
