"""Plain float32 train steps of SwinV2: the reference the checked steps of
the SwinV2 train cell are held to.

One step, as Swin's recipe defines it: uint8 images normalised with the
ImageNet mean and std; random erasing (each erased image's box filled with
normal noise, ``train.prepare``'s rule); batch-mode Mixup/CutMix (timm's:
the whole batch blends with, or pastes a box from, the batch reversed, the
targets smoothed and mixed by the realised weight); the soft-target
cross-entropy of the head; the gradients; their global norm clipped at
``clip_grad``; AdamW with decoupled weight decay on every leaf of rank > 1
except Swin's ``cpb_mlp`` and ``logit_scale``, at the epoch's learning rate
(``train.epoch_lr`` at the deployment's global batch).

The batch runs through ``swinv2.forward`` in chunks of ``chunk`` images
(the loss is a mean over the batch and nothing in SwinV2 mixes images, so
the chunks' gradients sum to the batch's), which keeps the float32 scores
of the explicit attention within the card. Computed in float32 with TF32
off; the random draws come in as inputs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from . import model as M, swinv2, train as T

NO_DECAY = ("cpb_mlp", "logit_scale")


def prepare(images_u8, labels, draws, mix, flags: Dict, classes: int):
    """Normalize, erase, mix: ``(images, targets)``; ``draws`` gives the
    erasing boxes and fill, ``mix`` the batch's Mixup/CutMix draw."""
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
    flipped = x.flip(0)
    lam = mix.lam(size)
    if mix.use_cutmix:
        iy = torch.arange(size, device=dev).view(-1, 1)
        ix = torch.arange(size, device=dev).view(1, -1)
        box = (iy >= mix.y0) & (iy < mix.y1) & (ix >= mix.x0) & (ix < mix.x1)
        x = torch.where(box[None, :, :, None], flipped, x)
    else:
        x = x * lam + flipped * (1.0 - lam)
    y = T.smooth_one_hot(labels, classes, flags["smoothing"])
    return x, y * lam + y.flip(0) * (1.0 - lam)


class Reference:
    """AdamW training of SwinV2 from ``params`` (name -> float32 tensor,
    copied). ``quant`` rounds the operands of every product and the residual
    stream (the control's lower precision); ``rows`` keeps only the first
    rows of each batch (a planted fault)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict, flags: Dict, classes: int,
                 chunk: int, quant: Callable = M.identity, rows=None):
        self.P = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
        self.cfg, self.flags, self.classes, self.chunk = cfg, flags, classes, chunk
        self.quant, self.rows = quant, rows
        self.m = {n: torch.zeros_like(t) for n, t in self.P.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.P.items()}
        self.t = 0

    def grads(self, images_u8, labels, draws, mix):
        """The batch's loss and gradients, chunk by chunk."""
        f = self.flags
        x, targets = prepare(images_u8, labels, draws, mix, f, self.classes)
        keeps = draws.keeps
        if self.rows is not None:
            x, targets = x[:self.rows], targets[:self.rows]
            keeps = [k[:self.rows] for k in keeps]
        b = x.shape[0]
        names = list(self.P)
        total = {n: torch.zeros_like(self.P[n]) for n in names}
        loss = 0.0
        for lo in range(0, b, self.chunk):
            hi = min(b, lo + self.chunk)
            logits = swinv2.forward(self.P, x[lo:hi], self.cfg, [k[lo:hi] for k in keeps],
                                    f["drop_path"], self.quant)
            part = T.soft_ce(logits, targets[lo:hi]) * ((hi - lo) / b)
            got = torch.autograd.grad(part, [self.P[n] for n in names], allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    total[n] += g
            loss += float(part.detach())
            del logits, part, got
        return loss, total

    def step(self, images_u8, labels, draws, mix, lr: float) -> Dict:
        """One step; returns its loss and the gradient as AdamW gets it
        (clipped)."""
        f = self.flags
        loss, grads = self.grads(images_u8, labels, draws, mix)
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        if f["clip_grad"] and norm >= f["clip_grad"]:
            for g in grads.values():
                g.mul_(f["clip_grad"] / norm)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, f["opt_eps"]
        with torch.no_grad():
            for n, p in self.P.items():
                g = grads[n]
                if p.ndim > 1 and not any(k in n for k in NO_DECAY):
                    p.mul_(1.0 - lr * f["weight_decay"])
                self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (self.v[n].sqrt() / math.sqrt(1.0 - b2 ** self.t)).add_(eps)
                p.addcdiv_(self.m[n], denom, value=-lr / (1.0 - b1 ** self.t))
        return {"loss": loss, "grads": grads}


def run_steps(params0: Dict[str, torch.Tensor], batches: List, cfg: Dict, flags: Dict,
              classes: int, start_step: int, steps_per_epoch: int, chunk: int,
              quant: Callable = M.identity, rows=None) -> Dict:
    """The checked steps from ``params0``: each step's loss, the first
    (clipped) gradient, and the parameters' change over all steps, on the
    host. ``batches`` holds ``(images, labels, draws, mix)`` per step."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(params0, cfg, flags, classes, chunk, quant, rows)
        losses, grads = [], None
        for i, (images, labels, draws, mix) in enumerate(batches):
            lr = T.epoch_lr(flags, flags["global_batch"],
                            (start_step + i) // steps_per_epoch)
            out = ref.step(images, labels, draws, mix, lr)
            losses.append(out["loss"])
            if i == 0:
                grads = T.to_host(out["grads"])
            del out
        change = T.to_host({n: ref.P[n].detach() - params0[n] for n in params0})
        return {"losses": losses, "grads": grads, "change": change, "ema_change": None}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
