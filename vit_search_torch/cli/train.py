"""Training / evaluation CLI of the port (reference ``main.py`` parity).

    python -m vit_search_torch.cli.train --model ... --data-path ... [flags]

Port of vit_search_tpu/cli/train.py with the same flags: every published
experiment script's flag set parses unchanged. The stack it drives:

  image folder -> host loader (uint8 batches) -> device feed (pinned
  memory, side-stream copies) -> train step on the card (normalize,
  erasing, masks, mixup, forward, loss, backward, AdamW, EMA) -> epoch loop
  with supernet epoch schedules + rewiring, per-epoch eval (+ EMA eval),
  JSON log lines, checkpoints (checkpoint / epoch@N / best / best_ema).

Differences from the JAX CLI:

- one process per device: ``--device`` is the CUDA device by default
  and the CPU only when ``--device cpu`` asks for it (no silent fallback;
  ``device.resolve_device``). Under ``cli.launch`` (``torchrun``) each
  process joins a ``torch.distributed`` group, trains on its card
  ``cuda:<local rank>`` and feeds its rank's shard of the global batch
  (``parallel``); only rank 0 writes logs and checkpoints, every rank
  restores, the eval totals are summed over processes, and a SIGTERM on
  any rank stops every rank at the same step (the flag is max-all-reduced
  where the metrics sync);
- ``--gelu`` goes to the model as an argument; no environment variable;
- ``best`` and ``best_ema`` are also written on an evaluated epoch while
  the checkpoint directory holds none, so a run whose evals all scored 0%
  still leaves the checkpoints that the finetune and eval scripts read (the
  JAX CLI writes them only on an accuracy above the last maximum, from 0);
- checkpoints are the port's (``train.checkpoint``); ``--resume`` also
  takes a local reference ``.pth(.tar)`` and a local archive;
- the KD teacher is rebuilt from its checkpoint's ``model``,
  ``nb_classes``/``num_classes``, ``network_def``, ``input_size`` and
  ``gelu`` arguments where present;
- ``--profile-dir`` writes a ``torch.profiler`` trace, the port's
  ``vst.*`` phase spans (``utils.trace``) beside the kernels.

Every train step draws from ``(seed, step)`` (``train.engine``) and the keep
counts from a ``(seed, epoch)`` host generator, so a run resumed after a
mid-epoch preemption replays the uninterrupted one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np

# Set by SIGTERM (scheduler preemption): the epoch loop checkpoints and
# exits cleanly so a relaunch with --resume continues (the submitit-requeue
# equivalent, reference run_with_submitit.py:62-72).
_PREEMPTED = threading.Event()


def _install_preemption_handler():
    """Route SIGTERM to ``_PREEMPTED``; returns the handler it replaced
    (``None`` off the main thread, where no handler can be installed)."""
    def handler(signum, frame):
        _PREEMPTED.set()

    try:
        return signal.signal(signal.SIGTERM, handler)
    except ValueError:
        return None  # not the main thread (tests)


def get_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("vit-search-torch training and evaluation",
                                     add_help=False)
    parser.add_argument("--batch-size", default=64, type=int,
                        help="per-process batch size")
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--val-bs", default=64, type=int)

    # Model
    parser.add_argument("--model", default="deit_base_patch16_224", type=str)
    parser.add_argument("--input-size", default=224, type=int)
    parser.add_argument("--drop", type=float, default=0.0)
    parser.add_argument("--drop-path", type=float, default=0.1)
    parser.add_argument("--drop-block", type=float, default=None)  # loud below
    parser.add_argument("--model-ema", action="store_true")
    parser.add_argument("--no-model-ema", action="store_false", dest="model_ema")
    parser.set_defaults(model_ema=True)
    parser.add_argument("--model-ema-decay", type=float, default=0.99996)
    parser.add_argument("--model-ema-force-cpu", action="store_true", default=False)

    # Optimizer
    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt-eps", default=1e-8, type=float)
    parser.add_argument("--opt-betas", default=None, type=float, nargs="+")
    parser.add_argument("--clip-grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight-decay", type=float, default=0.05)

    # LR schedule
    parser.add_argument("--sched", default="cosine", type=str)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--lr-noise", type=float, nargs="+", default=None)
    parser.add_argument("--lr-noise-pct", type=float, default=0.67)
    parser.add_argument("--lr-noise-std", type=float, default=1.0)
    parser.add_argument("--warmup-lr", type=float, default=1e-6)
    parser.add_argument("--min-lr", type=float, default=1e-5)
    parser.add_argument("--warmup-epochs", type=int, default=5)
    parser.add_argument("--decay-epochs", type=float, default=30)
    parser.add_argument("--cooldown-epochs", type=int, default=10)
    parser.add_argument("--decay-rate", "--dr", type=float, default=0.1)

    # Augmentation
    parser.add_argument("--color-jitter", type=float, default=0.4)
    parser.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    parser.add_argument("--smoothing", type=float, default=0.1)
    parser.add_argument("--train-interpolation", type=str, default="bicubic")
    parser.add_argument("--repeated-aug", action="store_true")
    parser.add_argument("--no-repeated-aug", action="store_false", dest="repeated_aug")
    parser.set_defaults(repeated_aug=True)
    parser.add_argument("--reprob", type=float, default=0.25)
    parser.add_argument("--remode", type=str, default="pixel")
    parser.add_argument("--recount", type=int, default=1)

    # Mixup
    parser.add_argument("--mixup", type=float, default=0.8)
    parser.add_argument("--cutmix", type=float, default=1.0)
    parser.add_argument("--cutmix-minmax", type=float, nargs="+", default=None)
    parser.add_argument("--mixup-prob", type=float, default=1.0)
    parser.add_argument("--mixup-switch-prob", type=float, default=0.5)
    parser.add_argument("--mixup-mode", type=str, default="batch")

    # Dataset
    parser.add_argument("--data-path", default="/datasets/imagenet", type=str)
    parser.add_argument("--data-set", default="IMNET", type=str)
    parser.add_argument("--inat-category", default="name", type=str)

    parser.add_argument("--output_dir", default="")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card) or 'cpu'; there is no fallback")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default="")
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--num_workers", default=10, type=int)
    parser.add_argument("--print-freq", default=100, type=int)

    # Knowledge distillation
    parser.add_argument("--teacher-ckpt-path", default=None, type=str)
    parser.add_argument("--teacher-model", default="regnety_160_upsample", type=str)
    parser.add_argument("--hard-distill", action="store_true", default=True)
    parser.add_argument("--distill-alpha", default=0.5, type=float)

    # Flexible ViT / supernet
    parser.add_argument("--network-def", default=None, type=str)
    parser.add_argument("--search-space", default=None, type=str)
    parser.add_argument("--example-per-arch", default=None, type=int)
    parser.add_argument("--num-warmup-epochs", default=30, type=int)
    parser.add_argument("--single-arch", action="store_true", default=False)
    parser.add_argument("--hybrid-arch", action="store_true", default=None)
    parser.add_argument("--use-holdout", action="store_true", default=False)
    parser.add_argument("--resume-supernet-weights", default=None, type=str)

    # Shifted patch token mixup
    parser.add_argument("--use-patch-mixup", action="store_true", default=False)
    parser.add_argument("--mixup-patch-len", default=4, type=int)
    parser.add_argument("--switch-prob", default=0.5, type=float)

    # Higher-resolution finetune
    parser.add_argument("--finetune", default=None, type=str)

    # Compute and run control
    parser.add_argument("--gelu", default="exact", choices=["exact", "tanh"],
                        help="GELU flavor: 'exact' (erf, the reference's nn.GELU) "
                             "or 'tanh' (the approximation)")
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="bfloat16 compute (params stay f32)")
    parser.add_argument("--no-bf16", action="store_false", dest="bf16")
    parser.add_argument("--max-steps-per-epoch", default=None, type=int,
                        help="truncate epochs (smoke tests)")
    parser.add_argument("--loader-backend", default=None,
                        choices=["thread", "process"],
                        help="data-loader worker backend (default: thread, "
                             "or VST_LOADER_BACKEND); 'process' scales host "
                             "decode past the GIL like torch DataLoader "
                             "workers (reference main.py:291-306)")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="write a torch.profiler trace of early steps")
    parser.add_argument("--profile-steps", default=8, type=int)
    return parser


def build_teacher(ckpt_path: str, default_model: str, num_classes: int, dtype, logger,
                  device=None):
    """Load the KD teacher, rebuilt from the checkpoint's embedded argument
    namespace when present (reference utils.py:218-238
    ``_load_teacher_model``: the checkpoint's ``args.model``/``args.nb_classes``
    define the teacher; the CLI flag is only a fallback). Returns
    ``train.make_teacher`` of it: eval mode, no gradient."""
    from .. import arch, models, train

    t_raw = train.restore_raw(ckpt_path)
    t_args = (t_raw.get("metadata") or {}).get("args") or {}
    model_name = t_args.get("model", default_model)
    t_classes = int(t_args.get("nb_classes", t_args.get("num_classes", num_classes)))
    kwargs = {}
    if not model_name.startswith("regnet"):
        if t_args.get("network_def"):
            kwargs["network_def"] = arch.parse_network_def(t_args["network_def"])
        if t_args.get("input_size"):
            kwargs["img_size"] = int(t_args["input_size"])
        if t_args.get("gelu"):
            kwargs["gelu"] = t_args["gelu"]
    teacher = models.create_model(model_name, num_classes=t_classes, dtype=dtype,
                                  device=device, **kwargs)
    teacher.load_state_dict({**t_raw["params"], **t_raw["batch_stats"]}, strict=True)
    logger.info(f"teacher: {model_name} (num_classes={t_classes}) from {ckpt_path}"
                + (" [reconstructed from ckpt args]" if t_args else ""))
    return train.make_teacher(teacher)


def _copy_into(model, tensors: Dict) -> None:
    """Copy ``tensors`` (name -> tensor) into ``model``'s parameters and
    buffers of those names."""
    import torch

    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        for name, t in tensors.items():
            own[name].copy_(t)


def _restore(step, raw: Dict, logger) -> Dict:
    """Put a port checkpoint (``restore_raw``'s output) into ``step``; its
    metadata. A checkpoint's EMA is dropped when the step keeps none (eval
    scripts pass ``--no-model-ema`` on checkpoints trained with one), and
    the step's EMA starts from the restored parameters when the checkpoint
    kept none."""
    has_ema, wants_ema = raw.get("ema_params") is not None, step.state.ema_params is not None
    if has_ema and not wants_ema:
        raw = {**raw, "ema_params": None}
        logger.info("checkpoint EMA not restored: this run keeps no EMA")
    elif wants_ema and not has_ema:
        raw = {**raw, "ema_params": dict(raw["params"])}
        logger.warning("checkpoint has no EMA: the EMA restarts from its parameters")
    step.load_state_dict(raw)
    return raw.get("metadata") or {}


def main(args) -> dict:
    import torch

    from .. import arch, data, hub, models, parallel, train, utils
    from ..models.supernet import SupernetSchedules

    device = parallel.process_device(args.device)
    n_proc, rank = parallel.process_count(), parallel.process_index()
    is_main = parallel.is_main_process()

    if args.drop_block is not None:
        # Every model family here is ViT/DeiT: none has a drop-block op.
        # The reference forwards the flag to timm create_model
        # (main.py:90-95,249) where the ViT factories reject the kwarg, so
        # failing loudly here IS the parity behavior (vs silently training
        # without the requested regularizer).
        raise NotImplementedError(
            "--drop-block is not supported by any ViT/DeiT model family")

    logger = utils.file_logger(args.output_dir or None, is_master=is_main)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + f"; {parallel.describe()}")
    logger.info(str(args))

    np.random.seed(args.seed + rank)

    # --- data ------------------------------------------------------------
    train_transform = data.TrainTransform(
        size=args.input_size, rand_augment=args.aa,
        color_jitter=args.color_jitter, interpolation=args.train_interpolation)
    eval_transform = data.EvalTransform(size=args.input_size)

    dataset_train = data.build_dataset(
        True, data_set=args.data_set, data_path=args.data_path,
        transform=train_transform, use_holdout=args.use_holdout,
        inat_category=args.inat_category)
    dataset_val = data.build_dataset(
        False, data_set=args.data_set, data_path=args.data_path,
        transform=eval_transform, use_holdout=args.use_holdout,
        inat_category=args.inat_category)
    num_classes = dataset_train.num_classes

    if args.repeated_aug:
        train_sampler = data.RepeatedAugmentSampler(len(dataset_train), n_proc, rank)
    else:
        train_sampler = data.ShardedSampler(len(dataset_train), n_proc, rank)
    val_sampler = data.ShardedSampler(len(dataset_val), n_proc, rank, shuffle=False)

    loader_train = data.DataLoader(dataset_train, train_sampler, args.batch_size,
                                   num_workers=args.num_workers, drop_last=True,
                                   seed=args.seed, worker_backend=args.loader_backend)
    loader_val = data.DataLoader(dataset_val, val_sampler, args.val_bs,
                                 num_workers=args.num_workers, drop_last=False,
                                 seed=args.seed, worker_backend=args.loader_backend)

    # --- model -----------------------------------------------------------
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    network_def = (arch.parse_network_def(args.network_def) if args.network_def else None)
    model_kwargs = dict(num_classes=num_classes, dtype=dtype, dropout_rate=args.drop,
                        drop_path_rate=args.drop_path, img_size=args.input_size,
                        gelu=args.gelu, seed=args.seed, device=device)
    if network_def is not None:
        model_kwargs["network_def"] = network_def
    model = models.create_model(args.model, **model_kwargs)
    network_def = model.network_def

    # supernet schedules (reference main.py:324-346 supernet kwargs wiring)
    schedules: Optional[SupernetSchedules] = None
    if models.is_supernet_model(args.model):
        if args.search_space is None:
            raise ValueError("--search-space required for supernet models")
        arch_mode = ("single" if args.single_arch
                     else "hybrid" if args.hybrid_arch else "multi")
        schedules = SupernetSchedules(
            network_def, arch.get_space(args.search_space),
            example_per_arch=args.example_per_arch,
            num_warmup_epochs=args.num_warmup_epochs, arch_mode=arch_mode)

    n_parameters = sum(p.numel() for p in model.parameters())
    logger.info(f"number of params: {n_parameters}")

    # --- weight surgery entries (finetune / supernet inheritance) ---------
    if args.finetune:
        train.load_finetune(model, args.finetune)
        logger.info(f"finetune: loaded + interpolated pos embeds from {args.finetune}")
    if args.resume_supernet_weights:
        raw = train.restore_raw(args.resume_supernet_weights)
        _copy_into(model, models.slice_subnet_params(raw["params"],
                                                     dict(model.named_parameters())))
        logger.info(f"inherited supernet weights from {args.resume_supernet_weights}")

    # --- teacher ----------------------------------------------------------
    teacher = None
    if args.teacher_ckpt_path:
        teacher = build_teacher(args.teacher_ckpt_path, args.teacher_model, num_classes,
                                dtype, logger, device)

    # --- optimizer / steps --------------------------------------------------
    global_batch = args.batch_size * n_proc
    steps_per_epoch = len(loader_train)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    betas = args.opt_betas or (0.9, 0.999)
    ocfg = train.OptimConfig(
        base_lr=args.lr, min_lr=args.min_lr, warmup_lr=args.warmup_lr,
        warmup_epochs=args.warmup_epochs, epochs=args.epochs,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        global_batch_size=global_batch, steps_per_epoch=max(1, steps_per_epoch),
        beta1=betas[0], beta2=betas[1], eps=args.opt_eps,
        lr_noise=args.lr_noise, lr_noise_pct=args.lr_noise_pct,
        lr_noise_std=args.lr_noise_std, seed=args.seed,
        sched=args.sched, decay_epochs=args.decay_epochs, decay_rate=args.decay_rate)
    optimizer = train.make_optimizer(ocfg, model)

    mixup_active = (args.mixup > 0 or args.cutmix > 0
                    or args.cutmix_minmax is not None)  # reference main.py:309
    mixup_mode = ("token" if args.use_patch_mixup
                  else "mixup" if mixup_active else "none")
    tcfg = train.TrainConfig(
        num_classes=num_classes, smoothing=args.smoothing,
        mixup_mode=mixup_mode, mixup_alpha=args.mixup,
        cutmix_alpha=args.cutmix, mixup_switch_prob=args.mixup_switch_prob,
        mixup_prob=args.mixup_prob, mixup_elem_mode=args.mixup_mode,
        cutmix_minmax=(tuple(args.cutmix_minmax) if args.cutmix_minmax else None),
        patch_len=args.mixup_patch_len,
        distill_alpha=args.distill_alpha, hard_distill=args.hard_distill,
        ema_decay=(args.model_ema_decay
                   if args.model_ema and not args.model_ema_force_cpu else None),
        erasing_prob=args.reprob, erasing_mode=args.remode,
        erasing_count=args.recount)
    if args.use_patch_mixup and args.input_size != 56 * args.mixup_patch_len:
        raise ValueError("--input-size must equal 56 * --mixup-patch-len "
                         "(reference README constraint)")

    step = train.make_train_step(
        model, optimizer, tcfg, schedule=train.lr_schedule(ocfg),
        counts_unpack=schedules.unpack if schedules is not None else None,
        seed=args.seed, device=device, teacher=teacher)
    eval_step = train.make_eval_step(model, device=device)

    # --model-ema-force-cpu: the EMA copy lives in HOST memory and updates
    # there once per step, the reference's timm ModelEma(device='cpu')
    # device-memory workaround (reference main.py:136-137). The step runs
    # EMA-free (ema_decay=None above); a checkpoint holds the host EMA in
    # the same slot as a device EMA, so the layout is the same in both modes.
    host_ema: Optional[Dict] = None
    if args.model_ema and args.model_ema_force_cpu:
        host_ema = {n: p.detach().to("cpu", torch.float32, copy=True)
                    for n, p in model.named_parameters()}

    @contextlib.contextmanager
    def host_ema_in_slot():
        """The host EMA in the step's EMA slot, for a save or a restore."""
        if host_ema is None:
            yield
            return
        step.state.ema_params = host_ema
        try:
            yield
        finally:
            step.state.ema_params = None

    ckpt = (train.CheckpointManager(os.path.join(args.output_dir, "checkpoints"))
            if args.output_dir else None)

    start_epoch = args.start_epoch
    meta: Dict = {}
    if args.resume:
        # 'auto' resumes from this run's own checkpoint dir; a directory
        # restores that checkpoint (eval scripts pass trained-model paths,
        # reference main.py:401-416); a URL is downloaded through the hub
        # cache first (reference main.py:402-404); a reference-format torch
        # file (local or fetched) restores weights, EMA and epoch; an
        # archive holds a checkpoint directory.
        local = (hub.download(args.resume) if args.resume.startswith(hub.URL_SCHEMES)
                 else args.resume)
        if local.endswith(hub.TORCH_SUFFIXES) and os.path.isfile(local):
            # Reference-format torch checkpoint (main.py:402-416): model
            # weights (+ BN buffers), EMA weights, epoch. Its optimizer was
            # built over other parameter groups, so the epoch restore resumes
            # the LR schedule at the right position but Adam's moments
            # restart; said loudly below.
            state_dicts = hub.load_torch_checkpoint(local)
            t_model, t_ema = state_dicts["model"], state_dicts.get("model_ema")
            if args.eval and t_ema is not None:
                # "when evaluating, use model_ema" (main.py:415-416)
                t_model = t_ema
            model.load_state_dict(t_model, strict=True)
            ema_slot = host_ema if host_ema is not None else step.state.ema_params
            if args.model_ema and t_ema is not None and ema_slot is not None:
                with torch.no_grad():
                    for name, t in ema_slot.items():
                        t.copy_(t_ema[name])
            if not args.eval and "epoch" in state_dicts:
                meta["epoch"] = state_dicts["epoch"]
                logger.warning(
                    "resume from torch checkpoint: epoch/LR schedule and EMA "
                    "restored, but the torch optimizer's moments are not: the "
                    "optimizer state restarts fresh")
            logger.info(f"resumed torch weights from {args.resume} "
                        f"(ema={'yes' if t_ema is not None else 'no'})")
        else:
            local = train.unpack_checkpoint_archive(local)
            if local != "auto" and os.path.isdir(local):
                path = local
            elif ckpt and ckpt.exists("checkpoint"):
                path = os.path.join(ckpt.directory, "checkpoint")
            else:
                raise FileNotFoundError(f"--resume {args.resume}: no checkpoint found")
            with host_ema_in_slot():
                meta = _restore(step, train.restore_raw(path, map_location=device), logger)
        if not args.eval:
            start_epoch = int(meta.get("epoch", -1)) + 1
        logger.info(f"resumed from epoch {meta.get('epoch')}")

    # Mid-epoch preemption resume: the preemption checkpoint holds the state
    # AFTER global step `preempted_step`, so re-entering the interrupted
    # epoch must SKIP the already-applied steps instead of re-applying them
    # on top of the mid-epoch state. Skipping is exact: each step's draws
    # come from the restored ``state.step``, the keep counts from a
    # ``(seed, epoch)`` host generator that is advanced through the skipped
    # steps, and the loader order is a function of the epoch, so the
    # resumed trajectory is bitwise the uninterrupted one.
    resume_skip_steps = 0
    if args.resume and not args.eval and "preempted_step" in meta:
        saved_spe = int(meta.get("steps_per_epoch", 0))
        if saved_spe == steps_per_epoch and steps_per_epoch > 0:
            done = int(meta["preempted_step"]) + 1  # steps fully applied
            resume_skip_steps = done % steps_per_epoch
            if resume_skip_steps == 0:  # preempted exactly at an epoch end
                start_epoch = done // steps_per_epoch
            else:
                logger.info(
                    f"mid-epoch resume: skipping the first {resume_skip_steps} "
                    f"already-applied steps of epoch {start_epoch}")
        else:
            logger.warning(
                f"preempted checkpoint was saved with steps_per_epoch="
                f"{saved_spe} but this run has {steps_per_epoch}; "
                f"re-running the interrupted epoch from its start on the "
                f"mid-epoch state (trajectory will differ from an "
                f"uninterrupted run)")

    eval_counts = schedules.full_counts() if schedules is not None else None

    def on_device(tree: Optional[Dict]) -> Optional[Dict]:
        return None if tree is None else {k: v.to(device) for k, v in tree.items()}

    def run_eval(params: Optional[Dict] = None) -> dict:
        """Eval over the val split; ``params`` (an EMA) in place of the
        model's parameters where given."""
        logger_eval = utils.MetricLogger(logger=logger)
        # Metric sums stay on the device; the host fetches every
        # VST_EVAL_SYNC_EVERY batches and once at the end, not one blocking
        # round trip per batch (the reference's prefetch-eval intent,
        # engine.py:194-261).
        sync_every = int(os.environ.get("VST_EVAL_SYNC_EVERY",
                                        os.environ.get("EVAL_SYNC_EVERY", "3")))
        totals: dict = {}
        device_acc, pending = None, 0

        def drain(acc):
            keys = list(acc)
            values = torch.stack([acc[k].double() for k in keys]).cpu().tolist()
            for k, v in zip(keys, values):
                totals[k] = totals.get(k, 0.0) + v

        for images, labels in data.prefetch_to_device(loader_val, device):
            m = eval_step(images, labels, eval_counts, params=params)
            device_acc = m if device_acc is None else {k: device_acc[k] + v
                                                       for k, v in m.items()}
            pending += 1
            if pending >= sync_every:
                drain(device_acc)
                device_acc, pending = None, 0
        if device_acc is not None:
            drain(device_acc)
        if not totals:
            return {}
        # the global sums: every process holds an equal shard of the split
        keys = sorted(totals)
        totals = dict(zip(keys, parallel.all_reduce_sum(
            np.array([totals[k] for k in keys], dtype=np.float64)).tolist()))
        count = max(totals.pop("count"), 1.0)
        stats = {("acc1" if k == "top1" else "acc5" if k == "top5" else k):
                 v / count * (100.0 if k.startswith(("top", "dst", "jnt")) else 1.0)
                 for k, v in totals.items()}
        stats["loss"] = totals["loss_sum"] / count
        stats.pop("loss_sum", None)
        logger_eval.update(**stats)
        logger.info(f"eval: {stats}")
        return stats

    def ema_tree() -> Optional[Dict]:
        return host_ema if host_ema is not None else step.state.ema_params

    if args.eval:
        if args.model_ema and ema_tree() is not None and args.resume:
            stats = run_eval(on_device(ema_tree()))
        else:
            stats = run_eval()
        return {"eval": stats}

    # --- pre-finetune sanity eval (reference main.py:453-455) ---------------
    if args.finetune:
        run_eval()

    # a flag left set by an earlier run in this process is not this run's
    _PREEMPTED.clear()
    previous_handler = _install_preemption_handler()
    logger.info(f"Start training for {args.epochs} epochs "
                f"({steps_per_epoch} steps/epoch, global batch {global_batch})")
    max_acc, max_ema_acc = 0.0, 0.0
    t_start = time.time()
    result: dict = {}
    named_params = dict(model.named_parameters())

    def save_epoch(epoch: int, metadata: dict, **best) -> None:
        """Rank 0 writes; every rank waits for the write to end before any
        rank reads it back."""
        if is_main:
            with host_ema_in_slot():
                ckpt.save_epoch(step, epoch, metadata=metadata, **best)
        parallel.barrier()

    try:
        for epoch in range(start_epoch, args.epochs):
            loader_train.set_epoch(epoch)
            skip_steps = resume_skip_steps if epoch == start_epoch else 0
            if schedules is not None:
                schedules.set_epoch(epoch)
                # epoch-boundary rewiring during warmup (vit_sr_supernet.py:465-477);
                # NOT on a mid-epoch resume: the restored state was already
                # rewired at this epoch's start before the preemption
                if epoch <= args.num_warmup_epochs and skip_steps == 0:
                    rewired = models.rewire_params(
                        {n: p.detach() for n, p in named_params.items()}, network_def)
                    _copy_into(model, {n: t.clone() for n, t in rewired.items()})

            metric_logger = utils.MetricLogger(logger=logger)
            metric_logger.add_meter("lr", utils.SmoothedValue(window_size=1, fmt="{value:.6f}"))

            # Per-step metrics stay on the device; the host fetches a WINDOW of
            # them in one blocking copy every `sync_every` steps, so the step
            # loop never waits on the device between syncs. Deviation from the
            # reference (engine.py:170-173): the non-finite-loss abort fires at
            # window granularity, up to sync_every-1 steps after the bad step.
            sync_every = max(1, int(os.environ.get("VST_TRAIN_SYNC_EVERY",
                                                   str(min(args.print_freq, 10)))))
            if host_ema is not None:
                sync_every = 1  # the per-step parameter fetch already syncs
            pending: list = []

            def drain_pending():
                if not pending:
                    return
                losses = torch.stack([m["loss"].float() for m in pending]).cpu().tolist()
                lrs = [m["lr"] for m in pending]
                pending.clear()
                for loss, lr in zip(losses, lrs):
                    if not np.isfinite(loss):
                        logger.error(f"Loss is {loss}, stopping training")
                        raise FloatingPointError(f"non-finite loss at epoch {epoch}")
                    metric_logger.update(loss=loss, lr=lr if lr is not None else 0.0)

            # keep counts are seeded by (seed, epoch) like the reference RNG
            # bracket (engine.py:119-132)
            host_rng = np.random.default_rng((args.seed, epoch))

            # device copies run `depth` batches ahead of the step loop
            feed = data.prefetch_to_device(loader_train, device)
            profiler = None
            epoch_t0 = time.time()
            steps_done = 0
            for it, (images, labels) in enumerate(metric_logger.log_every(
                    feed, args.print_freq, header=f"Epoch: [{epoch}]",
                    total=steps_per_epoch)):
                if it >= steps_per_epoch:
                    break
                global_step = epoch * steps_per_epoch + it
                if args.profile_dir and epoch == start_epoch and it == 1:
                    profiler = _start_profiler(device)
                # the counts of the GLOBAL batch, the same on every process
                # (vit_search_tpu/cli/train.py's rule); the step keeps its rows
                counts = (schedules.sample_packed(host_rng, images.shape[0] * n_proc)
                          if schedules is not None else None)
                if it < skip_steps:
                    # already applied before the preemption; the counts draw
                    # above advanced the host generator past this step
                    continue
                pending.append(step(images, labels, counts))
                steps_done += 1
                if host_ema is not None:
                    # the host twin of the step's EMA update (train/state.py);
                    # the per-step parameter fetch is the documented cost of
                    # the flag
                    train.ema_update(host_ema, {n: p.detach().cpu()
                                                for n, p in named_params.items()},
                                     args.model_ema_decay)
                if profiler is not None and it == args.profile_steps:
                    _stop_profiler(profiler, args.profile_dir)
                    profiler = None
                    logger.info(f"profiler trace written to {args.profile_dir}")
                at_sync = len(pending) >= sync_every or it == steps_per_epoch - 1
                if at_sync:
                    drain_pending()
                # a process group stops every rank at the same step: the ranks
                # agree on the flag where they sync (a max-all-reduce); one
                # process checks it after every step
                if (at_sync or n_proc == 1) and parallel.any_process(_PREEMPTED.is_set()):
                    drain_pending()
                    feed.close()
                    logger.warning(f"preempted at epoch {epoch} step {it}; "
                                   "checkpointing and exiting")
                    if ckpt:
                        save_epoch(epoch - 1, {"max_acc": max_acc, "preempted_step": global_step,
                                               "steps_per_epoch": steps_per_epoch,
                                               "args": vars(args)})
                    return {"preempted": True, "epoch": epoch, "step": it}
            feed.close()
            if profiler is not None:
                _stop_profiler(profiler, args.profile_dir)

            drain_pending()  # waits for the epoch's last step
            epoch_secs = time.time() - epoch_t0
            epoch_imgs_per_sec = steps_done * global_batch / epoch_secs if epoch_secs > 0 else 0.0
            logger.info(f"Epoch: [{epoch}] throughput: {epoch_imgs_per_sec:.1f} imgs/s "
                        f"({steps_done} steps, global batch {global_batch})")
            metric_logger.synchronize_between_processes(parallel.all_reduce_sum)
            train_stats = metric_logger.averages()
            train_stats["imgs_per_sec"] = epoch_imgs_per_sec
            logger.info(f"Averaged stats: {metric_logger}")

            test_stats = run_eval()
            ema_stats = {}
            if args.model_ema and ema_tree() is not None:
                ema_stats = run_eval(on_device(ema_tree()))

            # `best` (`best_ema`) on a new maximum, and on an evaluated epoch
            # of a run whose directory holds none yet: the scripts that read
            # them (the finetunes, the eval) find them even after epochs that
            # scored 0%, where the JAX CLI (`acc1 > max_acc` from 0.0) and the
            # reference write none
            acc1 = test_stats.get("acc1", 0.0)
            is_best = bool(test_stats) and (acc1 > max_acc or not (ckpt and ckpt.exists("best")))
            max_acc = max(max_acc, acc1)
            ema_acc1 = ema_stats.get("acc1", 0.0)
            is_best_ema = bool(ema_stats) and (ema_acc1 > max_ema_acc
                                               or not (ckpt and ckpt.exists("best_ema")))
            max_ema_acc = max(max_ema_acc, ema_acc1)
            logger.info(f"Max accuracy: {max_acc:.2f}%")

            log_stats = {**{f"train_{k}": v for k, v in train_stats.items()},
                         **{f"test_{k}": v for k, v in test_stats.items()},
                         **{f"ema_test_{k}": v for k, v in ema_stats.items()},
                         "epoch": epoch, "n_parameters": n_parameters}
            result = log_stats
            if args.output_dir and is_main:
                with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
                    f.write(json.dumps(log_stats) + "\n")
            if ckpt:
                save_epoch(epoch, {"max_acc": max_acc, "args": vars(args)},
                           is_best=is_best, is_best_ema=is_best_ema)

    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
    total = time.time() - t_start
    logger.info(f"Training time {total:.0f}s")
    return result


def _start_profiler(device):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, directory: str) -> None:
    profiler.stop()
    os.makedirs(directory, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(directory, "trace.json"))


if __name__ == "__main__":
    parser = argparse.ArgumentParser("vit-search-torch train", parents=[get_args_parser()])
    main(parser.parse_args())
