"""Plain float32 train steps of a ViT-ResNAS network: the reference the
checked steps of a train cell are held to.

One step, as the published recipe defines it: uint8 images normalized with
the ImageNet mean and std; random erasing (each erased image's box filled
with normal noise); shifted-patch token mixup (the first half of the batch
pastes a grid-aligned box from a partner, with per-patch targets; the second
half blends with a partner, its patch targets the image's); label smoothing;
the soft-target cross-entropy of the class head plus that of the patch head;
the gradients; AdamW (decoupled weight decay on every leaf of rank > 1
except the class token) at the epoch's learning rate of a cosine schedule
with linear warmup; an exponential moving average of the parameters.

Computed in float32 with TF32 off. The random draws come in as inputs
(``benchlib.draws.StepDraws``), as do the per-architecture keep counts of a
supernet step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M


def epoch_lr(flags: Dict, global_batch: int, epoch: int) -> float:
    """The learning rate of ``epoch``: linear warmup from ``warmup_lr``, then
    a cosine from the batch-scaled peak to ``min_lr`` over all epochs."""
    peak = flags["lr"] * global_batch / 512.0
    warmup, epochs = int(flags["warmup_epochs"]), int(flags["epochs"])
    if epoch < warmup:
        lr = flags["warmup_lr"] + epoch * (peak - flags["warmup_lr"]) / warmup
    else:
        lr = flags["min_lr"] + 0.5 * (peak - flags["min_lr"]) * (
            1.0 + math.cos(math.pi * epoch / epochs))
    return float(np.float32(lr))


def smooth_one_hot(labels: torch.Tensor, classes: int, smoothing: float) -> torch.Tensor:
    off = smoothing / classes
    return F.one_hot(labels.long(), classes).float() * (1.0 - smoothing) + off


def prepare(images_u8: torch.Tensor, labels: torch.Tensor, draws, flags: Dict, classes: int):
    """Normalize, erase, mix: ``(images, targets, patch_targets)``."""
    dev = images_u8.device
    x = images_u8.float() / 255.0
    x = (x - torch.tensor(M.MEAN, device=dev)) / torch.tensor(M.STD, device=dev)
    b, size = x.shape[0], x.shape[1]
    if flags["reprob"] > 0:
        iy = torch.arange(size, device=dev).view(1, size, 1)
        ix = torch.arange(size, device=dev).view(1, 1, size)
        y0, x0, eh, ew = (torch.as_tensor(draws.boxes[:, i], device=dev).view(b, 1, 1)
                          for i in range(4))
        on = torch.as_tensor(draws.erase, device=dev).view(b, 1, 1)
        box = (iy >= y0) & (iy < y0 + eh) & (ix >= x0) & (ix < x0 + ew) & on
        x = torch.where(box[..., None], draws.fill, x)
    grid, half = flags["mixup_patch_len"], b // 2
    onehot = smooth_one_hot(labels, classes, flags["smoothing"])
    # first half: a grid-aligned box pasted from a partner
    s1, y1 = x[:half], onehot[:half]
    perm = torch.as_tensor(draws.perm1, device=dev)
    by0, bx0, bh, bw = draws.box
    gy, gx = torch.arange(grid, device=dev).view(-1, 1), torch.arange(grid, device=dev).view(1, -1)
    cells = (gy >= by0) & (gy < by0 + bh) & (gx >= bx0) & (gx < bx0 + bw)
    patch = size // grid
    pix = cells.repeat_interleave(patch, 0).repeat_interleave(patch, 1)
    m1 = torch.where(pix[None, :, :, None], s1[perm], s1)
    per_cell = y1[:, None, None, :].expand(half, grid, grid, classes)
    p1 = torch.where(cells[None, :, :, None], per_cell[perm], per_cell).reshape(half, -1, classes)
    lam1 = float(np.float32(1.0) - np.float32(bh * bw) / np.float32(grid * grid))
    t1 = y1 * lam1 + y1[perm] * (1.0 - lam1)
    # second half: a blend with a partner
    s2, y2 = x[half:], onehot[half:]
    perm = torch.as_tensor(draws.perm2, device=dev)
    m2 = s2 * draws.lam + s2[perm] * (1.0 - draws.lam)
    t2 = y2 * draws.lam + y2[perm] * (1.0 - draws.lam)
    p2 = t2[:, None, :].expand(b - half, grid * grid, classes)
    return torch.cat([m1, m2]), torch.cat([t1, t2]), torch.cat([p1, p2])


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (-(targets * F.log_softmax(logits, dim=-1)).sum(-1)).mean()


class Reference:
    """AdamW training of a ViT-ResNAS network from ``params`` (name ->
    float32 tensor, copied). ``quant`` rounds the operands of every product
    (the control's lower precision); ``rows`` keeps only the first rows of
    each batch (a planted fault)."""

    def __init__(self, params: Dict[str, torch.Tensor], network_def: Sequence, space,
                 flags: Dict, classes: int, quant: Callable = M.identity,
                 rows: Optional[int] = None):
        self.P = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
        self.net, self.space, self.flags, self.classes = network_def, space, flags, classes
        self.quant, self.rows = quant, rows
        self.m = {n: torch.zeros_like(t) for n, t in self.P.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.P.items()}
        self.ema = ({n: t.detach().clone() for n, t in self.P.items()}
                    if flags["model_ema"] else None)
        self.t = 0

    def loss(self, images_u8, labels, packed, draws) -> torch.Tensor:
        f = self.flags
        x, targets, patch_targets = prepare(images_u8, labels, draws, f, self.classes)
        b = x.shape[0]
        masks = None
        if packed is not None:
            masks = M.masks_from_packed(torch.as_tensor(packed, device=x.device), self.net,
                                        self.space, b, b // f["example_per_arch"])
        keeps = draws.keeps
        if self.rows is not None:
            r = self.rows
            x, targets, patch_targets = x[:r], targets[:r], patch_targets[:r]
            keeps = [k[:r] for k in keeps]
            if masks is not None:
                masks = {"embed": masks["embed"][:r],
                         "slots": {s: {k: v[:r] for k, v in site.items()}
                                   for s, site in masks["slots"].items()}}
        cls, patches = M.forward(self.P, self.net, x, masks, keeps, f["drop_path"],
                                 gelu=f["gelu"], quant=self.quant)
        return soft_ce(cls, targets) + soft_ce(patches, patch_targets)

    def step(self, images_u8, labels, packed, draws, lr: float) -> Dict:
        """One step; returns its loss and the gradient as AdamW gets it."""
        f = self.flags
        loss = self.loss(images_u8, labels, packed, draws)
        names = list(self.P)
        grads = torch.autograd.grad(loss, [self.P[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(self.P[n]) if g is None else g
                 for n, g in zip(names, grads)}
        self.t += 1
        b1, b2, eps = 0.9, 0.999, f["opt_eps"]
        with torch.no_grad():
            for n, p in self.P.items():
                g = grads[n]
                if p.ndim > 1 and n != "tokens":
                    p.mul_(1.0 - lr * f["weight_decay"])
                self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (self.v[n].sqrt() / math.sqrt(1.0 - b2 ** self.t)).add_(eps)
                p.addcdiv_(self.m[n], denom, value=-lr / (1.0 - b1 ** self.t))
            if self.ema is not None:
                d = f["model_ema_decay"]
                for n, e in self.ema.items():
                    e.mul_(d).add_(self.P[n] * (1.0 - d))
        return {"loss": float(loss.detach()), "grads": grads}


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().float().cpu() for n, t in tensors.items()}


def run_steps(params0: Dict[str, torch.Tensor], batches: List, flags: Dict, network_def,
              space, classes: int, start_step: int, steps_per_epoch: int,
              quant: Callable = M.identity, rows: Optional[int] = None) -> Dict:
    """The checked steps from ``params0``: each step's loss, the first
    gradient, and the parameters' (and the EMA's) change over all steps, on
    the host. ``batches`` holds ``(images, labels, packed_counts, draws)``
    per step."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(params0, network_def, space, flags, classes, quant, rows)
        losses, grads = [], None
        for i, (images, labels, packed, draws) in enumerate(batches):
            lr = epoch_lr(flags, images.shape[0], (start_step + i) // steps_per_epoch)
            out = ref.step(images, labels, packed, draws, lr)
            losses.append(out["loss"])
            if i == 0:
                grads = to_host(out["grads"])
            del out
        change = to_host({n: ref.P[n].detach() - params0[n] for n in params0})
        ema = (None if ref.ema is None
               else to_host({n: ref.ema[n] - params0[n] for n in params0}))
        return {"losses": losses, "grads": grads, "change": change, "ema_change": ema}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
