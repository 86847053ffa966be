"""Training losses (log-softmax in float32) and top-k correct counts.

Port of vit_search_tpu/train/losses.py, the distillation loss included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(x.float(), dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE against integer labels."""
    logp = _log_softmax(logits)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    logp = _log_softmax(logits)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean of ``-sum(target * log_softmax(logits))`` over all leading axes;
    takes ``(B, K)`` class targets and ``(B, N, K)`` patch targets."""
    return (-(targets.float() * _log_softmax(logits)).sum(dim=-1)).mean()


def distillation_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      hard: bool = True, temperature: float = 3.0) -> torch.Tensor:
    """Knowledge distillation (reference engine.py:25-54). Hard: CE against
    the teacher's argmax. Soft: ``-sum(softmax(t / T) * log_softmax(s / T))
    * T^2``, a cross-entropy as the JAX package computes it (it differs from
    ``F.kl_div`` by the teacher's entropy)."""
    if hard:
        return cross_entropy(student_logits, teacher_logits.argmax(-1))
    t = temperature
    teacher_probs = torch.softmax(teacher_logits.float() / t, dim=-1)
    logp = _log_softmax(student_logits / t)
    return (-teacher_probs * logp).sum(-1).mean() * (t * t)


def top_k_correct(logits: torch.Tensor, labels: torch.Tensor, ks=(1, 5)) -> dict:
    """Per-batch correct counts for top-k accuracies (timm ``accuracy``)."""
    num_classes = logits.shape[-1]
    max_k = min(max(ks), num_classes)
    top = logits.float().topk(max_k, dim=-1).indices
    hit = top == labels.long().unsqueeze(-1)
    return {f"top{k}": hit[..., :min(k, num_classes)].any(dim=-1).sum() for k in ks}
