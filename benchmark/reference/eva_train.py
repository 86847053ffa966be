"""Plain float32 train steps of EVA-02: the reference the checked steps of
the EVA-02 fine-tune cell are held to.

One step, as the EVA-02 fine-tune defines it: uint8 images normalised with
the ImageNet mean and std, random erasing and batch-mode Mixup/CutMix with
the targets smoothed and mixed (``swin_train.prepare``: the same timm
rules); the soft-target cross-entropy of the head (``eva02.soft_ce``); the
gradients; AdamW with decoupled weight decay on every leaf of rank > 1
except ``pos_embed`` and ``cls_token``, at the epoch's learning rate
(``train.epoch_lr`` at the deployment's global batch) times each leaf's
layer-wise decay: ``decay ** (depth - i)`` for block ``i``,
``decay ** (depth + 1)`` for the patch projection, ``cls_token`` and
``pos_embed``, 1 for ``fc_norm`` and the head; then the EMA of the
parameters.

The batch runs through ``eva02.forward`` in chunks of ``chunk`` images
(the loss is a mean over the batch and nothing in EVA-02 mixes images, so
the chunks' gradients sum to the batch's), which keeps the float32 scores
of the explicit attention within the card. Computed in float32 with TF32
off; the random draws come in as inputs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

from . import eva02, model as M, swin_train, train as T

NO_DECAY = ("pos_embed", "cls_token")
STEM = ("patch_embed.", "cls_token", "pos_embed")


def lr_scale(name: str, depth: int, decay: float) -> float:
    """The layer-wise decay of leaf ``name``."""
    if name.startswith(STEM):
        return decay ** (depth + 1)
    if name.startswith("blocks."):
        return decay ** (depth - int(name.split(".")[1]))
    return 1.0


class Reference:
    """AdamW training of EVA-02 from ``params`` (name -> float32 tensor,
    copied), with the EMA. ``quant`` rounds the operands of every product
    and the residual stream (the control's lower precision); ``rows`` keeps
    only the first rows of each batch, ``faults`` leaves a part of the model
    out (planted faults)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict, flags: Dict, classes: int,
                 chunk: int, quant: Callable = M.identity, rows=None,
                 faults: Sequence[str] = ()):
        self.P = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
        self.cfg, self.flags, self.classes, self.chunk = cfg, flags, classes, chunk
        self.quant, self.rows, self.faults = quant, rows, tuple(faults)
        self.m = {n: torch.zeros_like(t) for n, t in self.P.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.P.items()}
        self.ema = {n: t.detach().clone() for n, t in self.P.items()}
        self.t = 0

    def grads(self, images_u8, labels, draws, mix):
        """The batch's loss and gradients, chunk by chunk."""
        f = self.flags
        x, targets = swin_train.prepare(images_u8, labels, draws, mix, f, self.classes)
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
            logits = eva02.forward(self.P, x[lo:hi], self.cfg, [k[lo:hi] for k in keeps],
                                   f["drop_path"], self.quant, self.faults)
            part = eva02.soft_ce(logits, targets[lo:hi]) * ((hi - lo) / b)
            got = torch.autograd.grad(part, [self.P[n] for n in names], allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    total[n] += g
            loss += float(part.detach())
            del logits, part, got
        return loss, total

    def step(self, images_u8, labels, draws, mix, lr: float) -> Dict:
        """One step; returns its loss and the gradient as AdamW gets it."""
        f = self.flags
        loss, grads = self.grads(images_u8, labels, draws, mix)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, f["opt_eps"]
        with torch.no_grad():
            for n, p in self.P.items():
                g = grads[n]
                rate = lr * lr_scale(n, self.cfg["depth"], f["layer_decay"])
                if p.ndim > 1 and not any(k in n for k in NO_DECAY):
                    p.mul_(1.0 - rate * f["weight_decay"])
                self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (self.v[n].sqrt() / math.sqrt(1.0 - b2 ** self.t)).add_(eps)
                p.addcdiv_(self.m[n], denom, value=-rate / (1.0 - b1 ** self.t))
            d = f["model_ema_decay"]
            for n, e in self.ema.items():
                e.mul_(d).add_(self.P[n] * (1.0 - d))
        return {"loss": loss, "grads": grads}


def run_steps(params0: Dict[str, torch.Tensor], batches: List, cfg: Dict, flags: Dict,
              classes: int, start_step: int, steps_per_epoch: int, chunk: int,
              quant: Callable = M.identity, rows=None, faults: Sequence[str] = ()) -> Dict:
    """The checked steps from ``params0``: each step's loss, the first
    gradient, and the parameters' and the EMA's change over all steps, on
    the host. ``batches`` holds ``(images, labels, draws, mix)`` per step."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(params0, cfg, flags, classes, chunk, quant, rows, faults)
        losses, grads = [], None
        for i, (images, labels, draws, mix) in enumerate(batches):
            lr = T.epoch_lr(flags, flags["global_batch"], (start_step + i) // steps_per_epoch)
            out = ref.step(images, labels, draws, mix, lr)
            losses.append(out["loss"])
            if i == 0:
                grads = T.to_host(out["grads"])
            del out
        change = T.to_host({n: ref.P[n].detach() - params0[n] for n in params0})
        ema = T.to_host({n: ref.ema[n] - params0[n] for n in params0})
        return {"losses": losses, "grads": grads, "change": change, "ema_change": ema}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
