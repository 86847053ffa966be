"""The CLI epoch cell: a published script through the port's training CLI
itself (``vit_search_torch.cli.train``'s ``main``, in this process), from a
folder of JPEGs on disk through the host loader, the device feed and the
CLI's own step loop.

Set-up makes the folder from the seed with ``tools/make_synthfolder.py``
(one process per host core; ``mixes/<mix>.json``'s ``folder``: classes,
images a class, their size) and its holdout split (``data.build_subsets``),
so the epoch reads every file once. It then runs the script's own
arguments (``script``), with the folder as ``IMAGENET_PATH``, one loader
worker per host core, the mix's epoch as ``--start_epoch``, no output
directory and the run's seed. Two of the port's entry points are wrapped
for the run: ``models.create_model`` loads weights made from the seed by
their state-dict names (``draws.make_weights``), and
``train.make_train_step`` puts the step at the mix's epoch and watches its
calls:

- call 0 is the checked step: the loader's first batch and the CLI's keep
  counts, with the draws handed in (``drivers/train.py``'s); its loss, the
  gradient as AdamW holds it and the parameters' change are kept, and the
  card is synchronised. It warms every shape the window uses;
- calls 1 to ``window_steps`` are the window, from the call of step 1 to the
  end of step ``window_steps`` on the card (``torch.cuda.synchronize()``);
  the rate is the window's images over that time. Each of its batches must
  be the next one that the loader yielded through the CLI's feed;
- after the window the CLI's own preemption flag stops the run (the feed
  closed, no checkpoint, no eval), so no later epoch or eval runs.

A traced run profiles the window itself: the device's idle share is the
card's wait on the host loader. After the CLI returns, the program's state
is freed and the float32 reference (``reference/train.py``) repeats the
checked step on the same batch, held to the limits of ``limits/<cell>.json``;
the folder is removed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import re
import shlex
import shutil
import sys
import time
from typing import Dict, List

from benchlib import compare, cost, device as dev, draws as D, harness, shapes
from benchlib.harness import log
from reference import train as ref_train

GIB = 2.0 ** 30
HERE = os.path.dirname(os.path.abspath(__file__))
# the ViT-ResNAS train cells' driver: its draws and their form for the program
base = harness.load_module(os.path.join(HERE, "train.py"), "bench_driver_train")
SPANS = ("bench.train_step", "vst.data.next")
THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def host_cores() -> int:
    return len(os.sched_getaffinity(0))


def script_argv(path: str, data_path: str) -> List[str]:
    """The arguments of the script's training command, from the one after
    ``-m vit_search_tpu.cli.train`` on, with ``IMAGENET_PATH`` set to
    ``data_path`` and every other variable at the script's default."""
    with open(path) as f:
        text = f.read()
    values = dict(re.findall(r'^(\w+)="\$\{\1:-([^}]*)\}"', text, re.M))
    values["IMAGENET_PATH"] = data_path
    words = shlex.split(re.sub(r"\\\n", " ", text), comments=True)
    module = next(w for w in words if w.startswith("vit_search_tpu.cli.train"))
    return [re.sub(r"\$\{?(\w+)\}?", lambda m: values[m.group(1)], w)
            for w in words[words.index(module) + 1:]]


def with_flags(argv: List[str], flags: Dict[str, str]) -> List[str]:
    """``argv`` with each flag of ``flags`` set to its value (replaced where
    present, else added)."""
    argv = list(argv)
    for flag, value in flags.items():
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    return argv


def recipe_flags(args) -> Dict:
    """The recipe as the reference and the checked step's draws read it,
    from the CLI's parsed arguments."""
    keys = ("batch_size", "input_size", "drop_path", "model_ema", "model_ema_decay", "opt_eps",
            "weight_decay", "lr", "warmup_lr", "min_lr", "warmup_epochs", "epochs", "smoothing",
            "reprob", "mixup_patch_len", "example_per_arch", "gelu")
    return {k: getattr(args, k) for k in keys}


def make_folder(run, root: str) -> None:
    """The seed's folder and its holdout split, one single-threaded process
    per host core (or the folder's ``workers``)."""
    from vit_search_torch.data import build_subsets
    from vit_search_torch.tools.make_synthfolder import generate

    spec, seed = run.mix["folder"], run.seed % 2**32
    before = {k: os.environ.get(k) for k in THREAD_ENV}
    os.environ.update({k: "1" for k in THREAD_ENV})
    try:
        with contextlib.redirect_stdout(sys.stderr):
            generate(root, num_classes=spec["classes"], train_per_class=spec["train"],
                     val_per_class=0, size=spec["size"], seed=seed,
                     workers=spec.get("workers") or host_cores())
            build_subsets(root, per_class=spec["holdout"], seed=seed)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Watched:
    """The CLI's train step, its calls watched (see the module's text)."""

    def __init__(self, run, step, watch: Dict):
        self.run, self.step, self.watch = run, step, watch
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, images, labels, counts=None, draws=None):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from vit_search_torch.cli import train as train_cli

        w, k, cuda = self.watch, self.calls, self.run.device == "cuda"
        self.calls += 1
        w["from_loader"] += int(id(images) == w["fed"])
        if k == 0:
            out = self.step(images, labels, counts,
                            draws=base.program_draws(base.step_draws(w["run"], 0)))
            named = dict(self.step.model.named_parameters())
            state = self.step.optimizer.state
            p0 = D.make_weights({n: p.shape for n, p in named.items()}, self.run.seed,
                                self.run.device)
            w["first"] = (images.cpu(), labels.cpu(), counts)
            w["got"] = {"losses": [float(out["loss"])], "ema_change": None,
                        "grads": base.to_host({n: state[p].get("exp_avg", torch.zeros_like(p))
                                               / (1.0 - 0.9) for n, p in named.items()}),
                        "change": base.to_host({n: p.detach() - p0[n]
                                                for n, p in named.items()})}
            del p0
            if cuda:
                torch.cuda.synchronize()
            return out
        last = k == w["window_steps"]
        if k == 1:
            if self.run.trace:
                w["profiler"] = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                w["profiler"].__enter__()
            w["t0"] = time.perf_counter()
        with record_function("bench.train_step"):
            out = self.step(images, labels, counts)
        w["losses"].append(out["loss"])
        if last:
            if cuda:
                torch.cuda.synchronize()
            w["t1"] = time.perf_counter()
            w["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
            if w.get("profiler") is not None:
                w["profiler"].__exit__(None, None, None)
            train_cli._PREEMPTED.set()   # the CLI's own clean stop after this step
        return out


@contextlib.contextmanager
def watched_cli(run, watch: Dict):
    """The CLI's model made from the seed's weights, its step watched and
    its feed's batches recorded, for the length of the block."""
    import torch
    from vit_search_torch import data, models, train

    create, make, feed = models.create_model, train.make_train_step, data.prefetch_to_device

    def create_model(name, **kwargs):
        model = create(name, **kwargs)
        named = dict(model.named_parameters())
        watch["leaf_shapes"] = {n: tuple(p.shape) for n, p in named.items()}
        weights = D.make_weights(watch["leaf_shapes"], run.seed, run.device)
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(weights[n])
        watch["network_def"] = model.network_def
        return model

    def make_train_step(*args, **kwargs):
        step = make(*args, **kwargs)
        step.state.step = run.mix["epoch"] * watch["steps_per_epoch"]
        return Watched(run, step, watch)

    def prefetch_to_device(batches, device, *args, **kwargs):
        for item in feed(batches, device, *args, **kwargs):
            watch["fed"] = id(item[0])
            yield item

    models.create_model, train.make_train_step = create_model, make_train_step
    data.prefetch_to_device = prefetch_to_device
    try:
        yield
    finally:
        models.create_model, train.make_train_step = create, make
        data.prefetch_to_device = feed


def run(run) -> Dict:
    import torch
    from vit_search_torch.cli import train as train_cli

    m, cfg = run.mix, run.config
    cuda = run.device == "cuda"
    root = os.path.join(os.path.dirname(run.here), ".bench_cache", f"cli_epoch_{os.getpid()}")
    try:
        log(run, f"making the folder ({host_cores()} processes)")
        make_folder(run, root)
        argv = script_argv(os.path.join(os.path.dirname(run.here), m["script"]), root)
        argv = with_flags(argv, {"--num_workers": str(host_cores()), "--output_dir": "",
                                 "--start_epoch": str(m["epoch"]), "--seed": str(run.seed % 2**31),
                                 "--device": run.device, **m.get("cli_flags", {})})
        args = train_cli.get_args_parser().parse_args(argv)
        spec = m["folder"]
        spe = spec["classes"] * (spec["train"] - spec["holdout"]) // args.batch_size
        if spe < 1 + m["window_steps"]:
            raise ValueError(f"the folder holds {spe} batches; the run needs "
                             f"{1 + m['window_steps']}")
        flags = recipe_flags(args)
        watch = {"run": dataclasses.replace(run, mix={**m, "flags": flags}),
                 "window_steps": m["window_steps"], "steps_per_epoch": spe, "fed": None,
                 "from_loader": 0, "losses": []}
        log(run, "cli.train " + " ".join(shlex.quote(a) for a in argv))
        with watched_cli(run, watch), contextlib.redirect_stdout(sys.stderr):
            train_cli.main(args)
        train_cli._PREEMPTED.clear()
        if "t1" not in watch:
            raise RuntimeError(f"the CLI ran {len(watch['losses']) + 1} steps; the window "
                               f"needs {1 + m['window_steps']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    steps, elapsed = m["window_steps"], watch["t1"] - watch["t0"]
    batch = args.batch_size
    imgs_per_s = steps * batch / elapsed
    setup_s = watch["t0"] - run.t_start
    losses = [float(v) for v in watch.pop("losses")]
    failed = sum(1 for v in losses if not math.isfinite(v))
    peak = watch["peak"]
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
    net = shapes.to_tuple(cfg["network_def"])
    if tuple(watch["network_def"]) != net:
        raise ValueError("the script's network_def is not the configuration's")
    if run.trace:
        trace = dev.reduce_trace(watch.pop("profiler").events(), SPANS)
        result["device"].update(busy_s=trace.get("busy_s", 0.0),
                                window_s=trace.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": trace.get("device_ops", []),
                               "idle_gaps": trace.get("idle_gaps", [])}
        result["ctx"] = {"run": run, "imgs_per_s": imgs_per_s, "trace": trace,
                         "macs_per_image": cost.macs(net, args.input_size)}

    images, labels, packed = watch.pop("first")
    got, unread = watch.pop("got"), (1 + steps) - watch["from_loader"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(run, "reference")
    p0 = D.make_weights(watch["leaf_shapes"], run.seed, run.device)
    first = (images.to(run.device), labels.to(run.device), packed,
             base.step_draws(watch["run"], 0))
    ref = ref_train.run_steps(p0, [first],
                              flags, net, cfg.get("space"), spec["classes"],
                              m["epoch"] * spe, spe)
    log(run, f"losses {got['losses']} against {ref['losses']}")
    numbers = compare.train_numbers(got, ref)
    numbers["unread_batches"] = (float(unread), "steps whose batch the loader did not feed")
    log(run, "numbers " + ", ".join(f"{k} {v:.4g} at {w}" for k, (v, w) in numbers.items()))
    correct, checks = compare.judge(numbers, run.limits["limits"])
    result.update(correct=correct and failed == 0, checks=checks)
    return result
