"""The train step and the eval steps.

Port of ``make_train_step`` (vit_search_tpu/train/engine.py:76-186):

  raw batch -> normalize uint8 -> random erasing -> unpack keep counts
  -> build masks -> token mixup or mixup/CutMix -> teacher forward (no
  gradient) -> masked forward (patch_output_type="seq") -> loss -> backward
  -> global norm -> clip -> AdamW -> EMA -> {loss, grad_norm, lr}

The loss is the JAX package's (engine.py:108-160): under token mixup the
soft-target CE on the cls and patch heads; under mixup/CutMix the
soft-target CE on the cls head; else label-smoothing CE (plain CE at
smoothing 0). Outside token mixup a teacher adds knowledge distillation on
the distill head (the cls head when the model has none):
``loss * (1 - alpha) + kd * alpha``, the teacher seeing the mixed images.

``grad_norm`` is measured before clipping, as ``optax.global_norm(grads)``
is. Host draws (token mixup, mixup/CutMix, erasing boxes) come from a
``numpy.random.Generator`` and device draws (stochastic depth, dropout,
erasing noise) from a ``torch.Generator`` on the model's device. Both are
derived anew in every call from ``(seed, state.step)``, the port's
counterpart of the JAX step's ``fold_in(rng, state.step)``
(vit_search_tpu/train/engine.py:95): a step restored from a checkpoint (which
holds ``state.step``) draws what an uninterrupted one draws at that step. A
:class:`StepDraws` injects any of them, so tests can feed in the JAX
package's draws.

In a process group (``parallel``) each process holds the rows ``[lo, hi)``
of the global batch and the step computes the global batch's function, as
the JAX step does over a mesh-sharded array: the parameters start equal
(broadcast from rank 0); the keep counts are unpacked and expanded for the
global batch and cut to the process's rows; when erasing or mixing is on,
the global batch is all-gathered first, so the host draws are made at the
global shape and a row's mixing partner may live on another process; the
stochastic-depth and dropout keeps are drawn at the global shape and cut
(``ops.row_draws``); the conv stem's batch statistics are global
(``models.patch_embed``); the gradients are averaged over processes in one
flat all-reduce before the norm, the clip and AdamW, and the reported loss
is the global mean. AdamW and the EMA then run alike on every process.

``make_eval_step`` and ``make_per_example_correct_step`` (engine.py:189-252)
run the model in eval mode under ``torch.no_grad()``, uint8 batches
normalized on the device; ``make_eval_step`` scores the model's parameters
or another set of them, such as the EMA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import parallel
from ..data.erasing import ErasingDraws, random_erasing
from ..data.mixup import MixupDraws, TokenMixDraws, mixup_cutmix, switch_token_mix
from ..device import resolve_device
from ..models.supernet import build_arch_masks
from ..ops.row_draws import RowShard
from ..utils.trace import span
from . import losses
from .optim import clip_by_global_norm_, global_norm
from .state import TrainState, ema_update, init_ema


MIXUP_MODES = ("none", "mixup", "token")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_classes: int = 1000
    smoothing: float = 0.1
    # 'none' | 'mixup' (timm Mixup/CutMix) | 'token' (SwitchTokenMix)
    mixup_mode: str = "none"
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_prob: float = 1.0
    mixup_elem_mode: str = "batch"  # timm Mixup mode: batch | elem | pair
    cutmix_minmax: Optional[tuple] = None
    patch_len: int = 4              # token-mixup grid (56px patches at 224px)
    # knowledge distillation (with a teacher)
    distill_alpha: float = 0.5
    hard_distill: bool = True
    distill_temperature: float = 3.0
    ema_decay: Optional[float] = None
    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)
    erasing_prob: float = 0.0       # --reprob
    erasing_mode: str = "pixel"     # --remode: pixel | rand | const
    erasing_count: int = 1          # --recount (timm max_count)


@dataclasses.dataclass
class StepDraws:
    """Injected random draws for one step."""

    mix: Optional[TokenMixDraws] = None
    drop_keeps: Optional[List[torch.Tensor]] = None  # (B,) keeps in call order
    erasing: Optional[ErasingDraws] = None
    mixup: Optional[MixupDraws] = None
    # dropout keep masks in call order (shapes: model.dropout_shapes(batch))
    dropout_keeps: Optional[List[torch.Tensor]] = None


def normalize(images: torch.Tensor, config: TrainConfig) -> torch.Tensor:
    """uint8 NHWC batches -> normalized float32; float input passes through."""
    if images.dtype != torch.uint8:
        return images
    x = images.float() / 255.0
    mean = torch.tensor(config.mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(config.std, dtype=torch.float32, device=images.device)
    return (x - mean) / std


def step_generators(seed: int, step: int, device) -> Tuple[np.random.Generator,
                                                            torch.Generator]:
    """The host and device generators of train step ``step`` of a run seeded
    ``seed``: a function of the pair alone."""
    words = np.random.SeedSequence((seed, step)).generate_state(2, np.uint32)
    device_seed = (int(words[0]) << 31) ^ int(words[1])
    return (np.random.default_rng((seed, step)),
            torch.Generator(device=device).manual_seed(device_seed))


def model_device(model: torch.nn.Module, device=None) -> torch.device:
    """The step's device (the CUDA device unless ``"cpu"`` is asked for);
    raises unless ``model`` is already there."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is not on {device}")
    return device


def check_on(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device``'s type."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}; the step runs on {device}")


def make_teacher(model: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """The KD teacher as the step calls it: ``teacher(images) -> logits``,
    ``model`` in eval mode under ``torch.no_grad()``. Build ``model`` in the
    student's compute dtype (``create_model("regnety_160_upsample",
    dtype=...)``); loading its weights from a checkpoint is the CLI's."""
    model.eval()

    @torch.no_grad()
    def teacher(images: torch.Tensor) -> torch.Tensor:
        return model(images)

    return teacher


class TrainStep:
    """``step(images, labels, counts, draws=None) -> {loss, grad_norm, lr}``.

    Each call's random draws are a function of ``(seed, state.step)``
    (:func:`step_generators`). ``counts`` is the keep-count tree, or with
    ``counts_unpack`` (``SupernetSchedules.unpack``) one packed int vector;
    ``None`` trains the dense net. ``loss`` and ``grad_norm`` stay on the
    device. With ``config.ema_decay`` the step keeps an EMA of the parameters in
    ``state.ema_params``; the optimizer's ``clip_grad`` (``make_optimizer``)
    clips the gradients by their global norm. ``teacher`` (see
    :func:`make_teacher`) maps the mixed images to logits for knowledge
    distillation.
    """

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 config: TrainConfig, schedule: Optional[Callable[[int], float]] = None,
                 counts_unpack: Optional[Callable] = None, seed: int = 0, device=None,
                 teacher: Optional[Callable] = None):
        device = model_device(model, device)
        if config.mixup_mode not in MIXUP_MODES:
            raise ValueError(f"mixup_mode must be one of {MIXUP_MODES}, "
                             f"got {config.mixup_mode!r}")
        self.model, self.optimizer, self.config = model, optimizer, config
        self.teacher = teacher
        self.schedule, self.counts_unpack = schedule, counts_unpack
        self.world, self.rank = parallel.process_count(), parallel.process_index()
        parallel.replicate(model)
        self.named_params = dict(model.named_parameters())
        self.state = TrainState(ema_params=init_ema(self.named_params)
                                if config.ema_decay else None)
        self.seed, self.device = seed, device
        self.params = [p for group in optimizer.param_groups for p in group["params"]]

    def __call__(self, images: torch.Tensor, labels: torch.Tensor, counts=None,
                 draws: Optional[StepDraws] = None) -> Dict:
        model, config = self.model, self.config
        draws = draws or StepDraws()
        with span("vst.train.step"):
            with span("vst.train.inputs"):
                rng, generator = step_generators(self.seed, self.state.step, self.device)
                model.train()
                batch = images.shape[0]
                global_batch, lo = batch * self.world, self.rank * batch
                # erasing and mixing draw at the global shape, and a row's mixing
                # partner may live on another process: they see the whole batch
                gather = self.world > 1 and (config.mixup_mode != "none"
                                             or config.erasing_prob > 0)
                if gather:
                    images, labels = parallel.all_gather(images), parallel.all_gather(labels)
                images = normalize(images, config)
                images = random_erasing(images, config.erasing_prob, config.erasing_mode,
                                        config.erasing_count, draws=draws.erasing, rng=rng,
                                        generator=generator)
            with span("vst.train.masks"):
                if counts is not None and self.counts_unpack is not None:
                    counts = self.counts_unpack(torch.as_tensor(counts, device=images.device),
                                                global_batch)
                masks = _rows(build_arch_masks(counts, model.network_def, global_batch,
                                               device=images.device), lo, batch, self.world)
            with span("vst.train.mix"):
                targets = patch_targets = None
                if config.mixup_mode == "token":
                    images, targets, patch_targets = switch_token_mix(
                        images, labels, config.patch_len, config.num_classes,
                        config.smoothing, draws=draws.mix, rng=rng)
                elif config.mixup_mode == "mixup":
                    images, targets = mixup_cutmix(
                        images, labels, config.num_classes, config.mixup_alpha,
                        config.cutmix_alpha, config.mixup_switch_prob, config.smoothing,
                        config.mixup_prob, mode=config.mixup_elem_mode,
                        cutmix_minmax=config.cutmix_minmax, draws=draws.mixup, rng=rng)
                if gather:
                    images, labels, targets, patch_targets = (
                        None if t is None else t[lo:lo + batch]
                        for t in (images, labels, targets, patch_targets))
            with span("vst.train.forward"):
                drop_keeps, dropout_keeps = draws.drop_keeps, draws.dropout_keeps
                if self.world > 1:
                    # per-example draws at the global shape, cut to this process's rows
                    generator = RowShard(generator, global_batch, lo, lo + batch)
                    drop_keeps = _rows(drop_keeps, lo, batch, self.world)
                    dropout_keeps = _rows(dropout_keeps, lo, batch, self.world)
                teacher_logits = None
                if self.teacher is not None and config.mixup_mode != "token":
                    with torch.no_grad():
                        teacher_logits = self.teacher(images)
                outputs = model(images, masks, patch_output_type="seq",
                                drop_keeps=drop_keeps, generator=generator,
                                dropout_keeps=dropout_keeps)

                if config.mixup_mode == "token":
                    cls_pred, patch_pred = outputs
                    loss = (losses.soft_target_cross_entropy(cls_pred, targets)
                            + losses.soft_target_cross_entropy(patch_pred, patch_targets))
                else:
                    cls_pred, dst_pred = (outputs if isinstance(outputs, tuple)
                                          else (outputs, outputs))
                    if config.mixup_mode == "mixup":
                        loss = losses.soft_target_cross_entropy(cls_pred, targets)
                    elif config.smoothing > 0:
                        loss = losses.label_smoothing_cross_entropy(cls_pred, labels,
                                                                    config.smoothing)
                    else:
                        loss = losses.cross_entropy(cls_pred, labels)
                    if teacher_logits is not None:
                        kd = losses.distillation_loss(dst_pred, teacher_logits,
                                                      config.hard_distill,
                                                      config.distill_temperature)
                        loss = loss * (1.0 - config.distill_alpha) + kd * config.distill_alpha
            with span("vst.train.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                for p in self.params:       # optax updates every leaf, used or not
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads = [p.grad for p in self.params]
            with span("vst.train.allreduce"):
                # equal shards: the mean of the processes' gradients is the global
                # batch's, and so is the mean of their losses
                parallel.all_reduce_mean_(grads)
                loss = parallel.all_reduce_sum(loss.detach()) / self.world
            with span("vst.train.update"):
                grad_norm = global_norm(grads)
                clip_grad = self.optimizer.param_groups[0].get("clip_grad")
                if clip_grad:
                    clip_by_global_norm_(grads, clip_grad, grad_norm)
                lr = self.schedule(self.state.step) if self.schedule is not None else None
                if lr is not None:
                    for group in self.optimizer.param_groups:
                        group["lr"] = lr * group.get("lr_scale", 1.0)
                self.optimizer.step()
            if self.state.ema_params is not None:
                with span("vst.train.ema"):
                    ema_update(self.state.ema_params, self.named_params, config.ema_decay)
            self.state.step += 1
        return {"loss": loss, "grad_norm": grad_norm, "lr": lr}

    def state_dict(self) -> Dict:
        """What a checkpoint holds: the step, the parameters, the BN
        statistics, the optimizer's state and the EMA (or ``None``)."""
        return {"step": self.state.step,
                "params": {n: p.detach() for n, p in self.model.named_parameters()},
                "batch_stats": {n: b for n, b in self.model.named_buffers()},
                "optimizer": self.optimizer.state_dict(),
                "ema_params": self.state.ema_params}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s output in place (strict on every key)."""
        self.model.load_state_dict({**state["params"], **state["batch_stats"]}, strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        ema = state["ema_params"]
        if (ema is None) != (self.state.ema_params is None):
            raise ValueError("the checkpoint and the step disagree on keeping an EMA")
        if ema is not None:
            if sorted(ema) != sorted(self.state.ema_params):
                raise KeyError("the checkpoint's EMA names other parameters")
            for name, t in self.state.ema_params.items():
                t.copy_(ema[name])
            parallel.replicate(self.state.ema_params)
        parallel.replicate(self.model)
        self.state.step = int(state["step"])


def _rows(tree, lo: int, batch: int, world: int):
    """``tree`` (a mask tree or a list of per-example tensors, or ``None``)
    with every tensor cut to the rows ``[lo, lo + batch)`` of the global
    batch; the tree itself when there is one process."""
    if tree is None or world == 1:
        return tree
    if isinstance(tree, dict):
        return {k: _rows(v, lo, batch, world) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rows(v, lo, batch, world) for v in tree]
    return tree[lo:lo + batch]


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    config: TrainConfig, schedule: Optional[Callable[[int], float]] = None,
                    counts_unpack: Optional[Callable] = None, seed: int = 0,
                    device=None, teacher: Optional[Callable] = None) -> TrainStep:
    """Build the train step; it runs on the CUDA device unless
    ``device="cpu"`` is asked for, and ``model`` must already be there (and
    ``teacher``'s model, :func:`make_teacher`, with it)."""
    return TrainStep(model, optimizer, config, schedule, counts_unpack, seed, device, teacher)


def _eval_outputs(model: torch.nn.Module, device: torch.device, images: torch.Tensor,
                  labels: torch.Tensor, counts: Optional[Dict],
                  params: Optional[Dict[str, torch.Tensor]] = None):
    """Eval-mode forward, with ``params`` in place of the model's parameters
    where given: ``(cls_pred, dst_pred or None)``."""
    check_on(device, images=images, labels=labels)
    model.eval()
    images = normalize(images, TrainConfig())
    masks = build_arch_masks(counts, model.network_def, images.shape[0], device=device)
    if params is None:
        outputs = model(images, masks)
    else:
        if sorted(params) != sorted(n for n, _ in model.named_parameters()):
            raise KeyError("params must name every parameter of the model")
        outputs = torch.func.functional_call(model, params, (images, masks))
    return outputs if isinstance(outputs, tuple) else (outputs, None)


def make_eval_step(model: torch.nn.Module, device=None) -> Callable:
    """``eval_step(images, labels, counts=None, params=None)`` -> summed
    metrics on the device: ``loss_sum``, ``top1``, ``top5``, ``count``, plus
    ``dst_*`` and ``jnt_*`` top-k for a distill-token model (reference
    engine.py:194-261). ``counts`` is a keep-count tree (round-robin over the
    batch) or ``None`` for the dense net. ``params`` (name -> tensor, e.g. a
    train step's ``state.ema_params``) replaces the model's parameters for
    the call, the BN statistics kept. Runs on the CUDA device unless
    ``device="cpu"``."""
    device = model_device(model, device)

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor,
                  counts: Optional[Dict] = None,
                  params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        cls_pred, dst_pred = _eval_outputs(model, device, images, labels, counts, params)
        batch = images.shape[0]
        metrics = {"count": torch.tensor(float(batch), device=device),
                   "loss_sum": losses.cross_entropy(cls_pred, labels) * batch}
        for prefix, pred in (("", cls_pred), ("dst_", dst_pred)):
            if pred is not None:
                metrics.update({prefix + k: v.float()
                                for k, v in losses.top_k_correct(pred, labels).items()})
        if dst_pred is not None:
            joint = cls_pred.float().softmax(-1) + dst_pred.float().softmax(-1)
            metrics.update({"jnt_" + k: v.float()
                            for k, v in losses.top_k_correct(joint, labels).items()})
        return metrics

    return eval_step


def make_per_example_correct_step(model: torch.nn.Module, device=None) -> Callable:
    """``step(images, labels, counts=None)`` -> ``(B,)`` float top-1
    correctness of the cls head, on the device. Runs on the CUDA device
    unless ``device="cpu"``."""
    device = model_device(model, device)

    @torch.no_grad()
    def step(images: torch.Tensor, labels: torch.Tensor,
             counts: Optional[Dict] = None) -> torch.Tensor:
        cls_pred, _ = _eval_outputs(model, device, images, labels, counts)
        return (cls_pred.argmax(-1) == labels).float()

    return step
