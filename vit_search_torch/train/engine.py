"""The train step and the eval steps.

Port of ``make_train_step`` (vit_search_tpu/train/engine.py:76-186), token
mixup branch:

  raw batch -> normalize uint8 -> unpack keep counts -> build masks
  -> token mixup -> masked forward (patch_output_type="seq")
  -> soft-target CE on the cls and patch heads -> backward -> AdamW
  -> {loss, grad_norm, lr}

Host draws (token mixup) come from a ``numpy.random.Generator`` and device
draws (stochastic depth) from a ``torch.Generator`` on the model's device,
both seeded by ``seed``; a :class:`StepDraws` injects either, so tests can
feed in the JAX package's draws. Mixup/CutMix, random erasing, EMA and
knowledge distillation wait for a later slice.

``make_eval_step`` and ``make_per_example_correct_step`` (engine.py:189-252)
run the model in eval mode under ``torch.no_grad()``, uint8 batches
normalized on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.mixup import TokenMixDraws, switch_token_mix
from ..device import resolve_device
from ..models.supernet import build_arch_masks
from . import losses
from .state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_classes: int = 1000
    smoothing: float = 0.1
    mixup_mode: str = "none"        # 'none' | 'token'; 'mixup' not ported yet
    patch_len: int = 4              # token-mixup grid (56px patches at 224px)
    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)


@dataclasses.dataclass
class StepDraws:
    """Injected random draws for one step."""

    mix: Optional[TokenMixDraws] = None
    drop_keeps: Optional[List[torch.Tensor]] = None  # (B,) keeps in call order


def normalize(images: torch.Tensor, config: TrainConfig) -> torch.Tensor:
    """uint8 NHWC batches -> normalized float32; float input passes through."""
    if images.dtype != torch.uint8:
        return images
    x = images.float() / 255.0
    mean = torch.tensor(config.mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(config.std, dtype=torch.float32, device=images.device)
    return (x - mean) / std


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


class TrainStep:
    """``step(images, labels, counts, draws=None) -> {loss, grad_norm, lr}``.

    ``counts`` is the keep-count tree, or with ``counts_unpack``
    (``SupernetSchedules.unpack``) one packed int vector; ``None`` trains the
    dense net. ``loss`` and ``grad_norm`` stay on the device.
    """

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 config: TrainConfig, schedule: Optional[Callable[[int], float]] = None,
                 counts_unpack: Optional[Callable] = None, seed: int = 0, device=None):
        device = model_device(model, device)
        if config.mixup_mode not in ("none", "token"):
            raise NotImplementedError(f"mixup_mode {config.mixup_mode!r} is not ported yet")
        self.model, self.optimizer, self.config = model, optimizer, config
        self.schedule, self.counts_unpack = schedule, counts_unpack
        self.state = TrainState()
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.params = [p for group in optimizer.param_groups for p in group["params"]]

    def __call__(self, images: torch.Tensor, labels: torch.Tensor, counts=None,
                 draws: Optional[StepDraws] = None) -> Dict:
        model, config = self.model, self.config
        draws = draws or StepDraws()
        model.train()

        images = normalize(images, config)
        batch = images.shape[0]
        if counts is not None and self.counts_unpack is not None:
            counts = self.counts_unpack(torch.as_tensor(counts, device=images.device), batch)
        masks = build_arch_masks(counts, model.network_def, batch, device=images.device)

        if config.mixup_mode == "token":
            images, targets, patch_targets = switch_token_mix(
                images, labels, config.patch_len, config.num_classes, config.smoothing,
                draws=draws.mix, rng=self.rng)
        outputs = model(images, masks, patch_output_type="seq",
                        drop_keeps=draws.drop_keeps, generator=self.generator)

        if config.mixup_mode == "token":
            cls_pred, patch_pred = outputs
            loss = (losses.soft_target_cross_entropy(cls_pred, targets)
                    + losses.soft_target_cross_entropy(patch_pred, patch_targets))
        else:
            cls_pred = outputs[0] if isinstance(outputs, tuple) else outputs
            if config.smoothing > 0:
                loss = losses.label_smoothing_cross_entropy(cls_pred, labels, config.smoothing)
            else:
                loss = losses.cross_entropy(cls_pred, labels)

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params:       # optax updates every leaf, used or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in self.params]))

        lr = self.schedule(self.state.step) if self.schedule is not None else None
        if lr is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, "lr": lr}


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    config: TrainConfig, schedule: Optional[Callable[[int], float]] = None,
                    counts_unpack: Optional[Callable] = None, seed: int = 0,
                    device=None) -> TrainStep:
    """Build the train step; it runs on the CUDA device unless
    ``device="cpu"`` is asked for, and ``model`` must already be there."""
    return TrainStep(model, optimizer, config, schedule, counts_unpack, seed, device)


def _eval_outputs(model: torch.nn.Module, device: torch.device, images: torch.Tensor,
                  labels: torch.Tensor, counts: Optional[Dict]):
    """Eval-mode forward: ``(cls_pred, dst_pred or None)``."""
    check_on(device, images=images, labels=labels)
    model.eval()
    images = normalize(images, TrainConfig())
    masks = build_arch_masks(counts, model.network_def, images.shape[0], device=device)
    outputs = model(images, masks)
    return outputs if isinstance(outputs, tuple) else (outputs, None)


def make_eval_step(model: torch.nn.Module, device=None) -> Callable:
    """``eval_step(images, labels, counts=None)`` -> summed metrics on the
    device: ``loss_sum``, ``top1``, ``top5``, ``count``, plus ``dst_*`` and
    ``jnt_*`` top-k for a distill-token model (reference engine.py:194-261).
    ``counts`` is a keep-count tree (round-robin over the batch) or ``None``
    for the dense net. Runs on the CUDA device unless ``device="cpu"``."""
    device = model_device(model, device)

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor,
                  counts: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        cls_pred, dst_pred = _eval_outputs(model, device, images, labels, counts)
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
