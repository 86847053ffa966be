"""Batched candidate scoring on the supernet.

Port of the JAX package's ``search/batched_eval.py``. The reference scores
each search candidate by building a new model, slicing supernet weights into
it and running a full sub-val evaluation (evo_search.py:253-287). Here
candidates become keep-count columns: every sub-val batch is tiled ``A``
times on the device, candidate-major (example ``a * B + i`` is image ``i``
under candidate ``a``; training's round-robin order is a different one), and
one masked forward scores ``A`` candidates at once. Valid because candidate
extraction is prefix slicing and the masked forward equals the sliced one.

Across processes (``parallel``), the counterpart of the JAX evaluator's
``mesh``: each process scores the sub-val shard its loader gives it (a
``ShardedSampler`` of its rank), and the per-candidate correct sums and the
valid-row total are all-reduced before the division, so every process
returns the same scores.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
from ..models.supernet import SupernetSchedules, build_arch_masks
from ..train.engine import TrainConfig, check_on, model_device, normalize
from ..utils.trace import span

SCORE_HEADS = ("cls", "dst", "joint")
# the engine's ImageNet mean and std (the reference normalizes search-eval
# batches in its GPU prefetcher, datasets.py:170-184)
_EVAL_CONFIG = TrainConfig()


def _num_candidates(counts: Dict) -> int:
    if counts.get("embed") is not None:
        return len(counts["embed"])
    return len(next(iter(next(iter(counts["slots"].values())).values())))


def make_tiled_correct_step(model: torch.nn.Module, score_head: str = "cls",
                            device=None) -> Callable:
    """``step(images, labels, valid, counts)`` -> ``(per-candidate correct
    (A,), sum of valid)``, both on the device.

    ``counts`` holds ``(A,)`` keep counts per site
    (``SupernetSchedules.counts_for_subnets``). The ``(B, H, W, 3)`` batch is
    normalized (uint8) once, before it is tiled to ``(A * B, ...)``.
    ``valid`` weights each row, so padding rows score 0. ``score_head``
    picks the fitness logits: ``cls``, ``dst`` (the distill head, what the
    reference scores a distill supernet by, evo_search.py:280-282) or
    ``joint`` (the sum of both heads' softmax). Runs on the CUDA device
    unless ``device="cpu"``, and raises on tensors elsewhere.
    """
    if score_head not in SCORE_HEADS:
        raise ValueError(f"unknown score head {score_head!r}")
    if score_head in ("dst", "joint") and not getattr(model, "distill_token", False):
        raise ValueError(f"score head {score_head!r} needs a distill-token supernet")
    device = model_device(model, device)

    @torch.no_grad()
    def step(images: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
             counts: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        check_on(device, images=images, labels=labels, valid=valid)
        model.eval()
        images = normalize(images, _EVAL_CONFIG)    # once per image, not A times
        a, b = _num_candidates(counts), images.shape[0]

        def per_example(v):
            return None if v is None else torch.as_tensor(v, device=device).repeat_interleave(b)

        tiled = {"embed": per_example(counts.get("embed")),
                 "slots": {slot: {k: per_example(v) for k, v in site.items()}
                           for slot, site in counts["slots"].items()}}
        masks = build_arch_masks(tiled, model.network_def, a * b, device=device)
        outputs = model(images.repeat(a, 1, 1, 1), masks)
        if score_head == "cls":
            pred = outputs[0] if isinstance(outputs, tuple) else outputs
        elif score_head == "dst":
            pred = outputs[1]
        else:
            pred = outputs[0].float().softmax(-1) + outputs[1].float().softmax(-1)
        valid = valid.float()
        correct = (pred.argmax(-1) == labels.repeat(a)).float() * valid.repeat(a)
        return correct.view(a, b).sum(1), valid.sum()

    return step


class BatchedSupernetEvaluator:
    """Score populations of network_defs on a fixed sub-val loader.

    ``loader`` yields ``(images, labels)`` or ``(images, labels, valid)``
    batches, as numpy arrays (copied to the device) or tensors already on
    it. ``score_head="auto"`` takes ``dst`` for a distill-token supernet and
    ``cls`` otherwise, as the reference does (evo_search.py:280-285). Runs
    on the CUDA device unless ``device="cpu"``.
    """

    def __init__(self, model: torch.nn.Module, schedules: SupernetSchedules, loader,
                 arch_batch: int = 8, score_head: str = "auto", device=None):
        if score_head == "auto":
            score_head = "dst" if getattr(model, "distill_token", False) else "cls"
        self.model = model
        self.schedules = schedules
        self.loader = loader
        self.arch_batch = arch_batch
        self.score_head = score_head
        self.device = model_device(model, device)
        self._step = make_tiled_correct_step(model, score_head, self.device)

    def _tensor(self, v, name: str) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            check_on(self.device, **{name: v})
            return v
        return torch.as_tensor(np.asarray(v), device=self.device)

    def _score_chunk(self, sub_defs: Sequence) -> np.ndarray:
        with span("vst.search.chunk"):
            with span("vst.search.counts"):
                counts = self.schedules.counts_for_subnets(sub_defs)
                counts = {"embed": None if counts["embed"] is None
                          else torch.as_tensor(counts["embed"], device=self.device),
                          "slots": {slot: {k: torch.as_tensor(v, device=self.device)
                                           for k, v in site.items()}
                                    for slot, site in counts["slots"].items()}}
                # correct counts and the valid-row total stay on the device; the
                # host reads them once per chunk
                correct = torch.zeros(len(sub_defs), dtype=torch.float64, device=self.device)
                total = torch.zeros((), dtype=torch.float64, device=self.device)
            for batch in self.loader:
                with span("vst.search.batch"):
                    images = self._tensor(batch[0], "images")
                    labels = self._tensor(batch[1], "labels")
                    valid = (self._tensor(batch[2], "valid") if len(batch) > 2
                             else torch.ones(images.shape[0], device=self.device))
                    per_candidate, valid_sum = self._step(images, labels, valid, counts)
                    correct += per_candidate
                    total += valid_sum
            with span("vst.search.readback"):
                sums = parallel.all_reduce_sum(torch.cat([correct, total.view(1)])).cpu().numpy()
        return sums[:-1] / max(float(sums[-1]), 1.0) * 100.0

    def score(self, network_defs: Sequence,
              progress: Optional[Callable[[str], None]] = None) -> List[float]:
        """Top-1 accuracy (%) on the sub-val set for each candidate.

        Chunks of up to ``arch_batch`` candidates run as one tiled forward,
        and the last partial chunk at its own size. (The JAX evaluator pads
        that chunk with repeats so that every chunk reuses one compiled
        program; eager PyTorch compiles nothing, so repeats would only be
        wasted forwards.) ``progress`` gets a status line every 10 chunks.
        """
        import time

        t0 = time.time()
        scores: List[float] = []
        defs = list(network_defs)
        n_chunks = -(-len(defs) // self.arch_batch)
        for i in range(0, len(defs), self.arch_batch):
            if progress and (i // self.arch_batch) % 10 == 0 and i:
                progress(f"scored {i}/{len(defs)} candidates ({time.time() - t0:.0f}s, "
                         f"{i // self.arch_batch}/{n_chunks} chunks)")
            scores.extend(self._score_chunk(defs[i:i + self.arch_batch]))
        return scores
