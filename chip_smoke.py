#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card (an H100).

    python3 chip_smoke.py [--out DIR]

Phases, each fatal on failure (non-zero exit, no result line):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the hand-written kernels from ``vit_search_torch/csrc`` (nvcc, sm_90a);
3. every kernel against its plain PyTorch version at the three stage shapes
   of the ViT-ResNAS-Tiny supernet, at the batch each main path gives it
   (512 for the train step and the op-level API; 2048 for a scoring
   forward: K1, K3 and K5; 512 for the attention lab's K10-K12), with
   stated tolerances, and timed with CUDA events beside its bound and
   PyTorch's own call: ``ms`` is the device time per launch (launches
   captured in a CUDA graph, inputs rotated past the L2 cache), ``call_ms``
   the time per call of the wrapper, host overhead included. The inputs are
   bf16, so K1/K2 and K6-K9 run their tensor-core bodies, which round p
   and ds to bf16 as MMA operands where the plain versions keep them f32:
   they agree within ``BF16_TOL``, not bit for bit. The lab's K10 and K11
   run the same bodies with p and ds as bf16 hi/lo pairs: their mean error
   against the f32 function must be below K1's and K2's on the card, and
   each lab entry carries ``err_vs_base``, its error against K1's or K2's
   plain function. K3/K4's yardstick is ``F.layer_norm`` (their function
   with a full mask); K3's and K4's registers and spills from the ptxas
   report go to stderr; at the very end, after the lab, K4's two launches
   (the rows, then the fold of the per-block partials) are timed apart by
   ``torch.profiler``;
   Beside the stage shapes, the attention kernels at shapes past the
   supernet's: the 392 px finetune's stage 1 (N = 785, D = 32, where the
   bf16 backward takes the split route), K1/K2 in bf16 and float32 and
   K6-K9 in bf16, and K1/K2 at a head dim of 24; then K1/K2 at the searched
   Tiny net's stages (widest heads, B = 512), at the 392 px finetune's
   three stages (B = 64) and at DeiT-S's shape (B = 512, N = 198, 6 heads
   of 64); and K3/K4's dense mode (a net without masks) at
   ViT-ResNAS-Medium's stage shapes at 224 px (B = 1024) and at 392 px
   (B = 256) against the plain dense layer norm in float32, timed beside it
   and ``F.layer_norm``; then the conv stem's batch norm with its ReLU (B1,
   and B2 in train mode, ``csrc/batch_norm.cu``) at the cells' stem shapes
   (``STEM_CASES``: B 1024 at 224 px and B 256 at 392 px in train mode, B
   2048 at 224 px in eval mode; 24 channels at half resolution, in the
   layout the stem's convolution returns) against the float32 PyTorch ops
   the port ran before, timed beside its bound (three passes over the
   activation forward, five backward), those ops and ``F.batch_norm`` with
   ``F.relu`` (cuDNN), and the whole ``PatchConvEmbed`` through its module:
   3 / 3 / 3 launches of ``batch_norm_stats`` / ``_apply`` / ``_bwd`` a
   train pass, 0 / 3 / 0 an eval forward, each norm's input and gradient
   layout, no float32 activation saved for the backward (``--phase stem``
   runs this alone after the build);
4. a small conv-stem supernet: the port's forward and one train step on the
   card (kernels) against the same on the CPU (plain versions), in float32
   (the attention kernels' CUDA-core f32 bodies), once on each masked-LN
   route (``fused``: K3/K4; ``stats``: K5), then in bfloat16 (the
   tensor-core bodies) on the fused route: loss, gradient norm and logits
   within ``REF_NET_BF16_TOL``; then the same net trained densely, as a
   searched net, with random erasing, gradient clipping and the EMA on, the
   draws made once on the host for both devices, in float32 and bfloat16:
   loss, gradient norm, logits and the EMA within the same tolerances; then
   the same net with a distill token, one step with timm Mixup/CutMix
   (``elem`` mode), dropout 0.1 with injected keeps and hard distillation
   from a narrow RegNetY teacher behind a shrinking resize, in float32 and
   bfloat16 (the teacher in float32: a bf16 teacher's hard labels flip on
   near-ties); the teacher's logits card vs CPU in float32 and, apart, in
   bfloat16;
5. the op-level API at each stage shape, forward and backward through
   autograd: ``fused_attention_packed`` and ``fused_attention`` (K6/K7),
   ``fused_attention_qkv_t`` (K8/K9); outputs of the expected shapes, the
   ``(B, N, H, D)`` entry point equal to the ``(B, N, W)`` one, and one
   launch of each kernel per call (the plain comparisons are phase 3's);
   then (``shapes``) ``fused_attention_qkv`` (K1/K2) at the 392 px
   finetune's three stage shapes in both dtypes and at a head dim of 24,
   and the other two layouts' entry points (K6-K9) at its stage 1 in bf16;
6. train: the full-width ``SUPERNET_SR_TINY_MH`` supernet at 224px, batch
   512, 32 examples per architecture, token mixup, drop_path 0.2, tanh GELU,
   bf16 compute, AdamW; every loss finite, and each kernel's launch count
   moves by exactly its per-step count; one more step under
   ``torch.profiler``, its device time by kernel class;
   searched (``searched_net/tiny.sh``): the dense ViT-ResNAS-Tiny at 224 px,
   batch 512, token mixup, drop_path 0.2, random erasing 0.25 (pixel), EMA
   0.99996, AdamW, bf16: every loss finite, the EMA finite and not the
   parameters, K1/K2 16 launches per step, K3/K4's dense mode 35 (a dense
   net's layer norms: 2 per block, 1 per SR block, 1 final) and the masked
   K3/K4 and K5 none;
   finetune (``finetune/medium_img-size@392.sh``): ViT-ResNAS-Medium trains
   two steps at 224 px with the EMA, is saved by ``CheckpointManager`` and
   read back by ``restore_raw``; ``load_finetune`` resizes the EMA's
   position tables on the card into the 392 px net (within 1e-5 of the
   same surgery on the CPU, the cls rows bit for bit), which trains at
   batch 64, patch_len 7, drop_path 0.75, lr 5e-6, weight decay 1e-8,
   erasing and EMA on: K1/K2 20 launches per step, and the profiled step's
   backward launches by name show K2's split route at stage 1 (N = 785);
   mixup (``super_net/no_distill/tiny_mh.sh``): the script's own network_def
   (linear stem) as ``flexible_vit_sr_patch14_224_supernet``, space
   ``sr_tiny_mh``, batch 512, 32 examples per architecture, timm
   Mixup/CutMix (0.8 / 1.0, switch 0.5, batch mode), smoothing 0.1,
   drop_path 0.2, tanh GELU, bf16, no EMA: K1/K2 18 and K3/K4 39 launches
   per step;
   distill (the DeiT-S distillation recipe of the facebookresearch/deit
   README): ``deit_small_distill_patch16_224`` at batch 512 with hard
   distillation (alpha 0.5) from ``regnety_160_upsample`` (RegNetY-16GF,
   random weights from seed 0, bf16, eval mode), Mixup/CutMix as above,
   smoothing 0.1, drop_path 0.1, EMA 0.99996: K1/K2 12 launches per step at
   (198, 6, 64), K3/K4's dense mode 25, the masked K3/K4 and K5 none; the
   teacher's forward timed apart by CUDA events, its share of the step
   reported;
   loader (``super_net/tiny.sh``'s input pipeline): a synthetic image folder
   made by the port's ``make_synthfolder`` in a temporary directory (1000
   classes, 4 images per class at 256 px, 1 per class held out as the
   sub-val by ``build_subsets``); the port's ``DataLoader`` alone on the
   process backend with one worker per host core (``TrainTransform`` at
   224 px, RandAugment ``rand-m9-mstd0.5-inc1``, batch 512), timed over an
   epoch; the train phase's step fed from it through the device feed
   (``data.prefetch_to_device``), K1/K2 18 and K3/K4 39 launches per step;
   one step, its batch's wait included, under the profiler: the device's
   idle share; the host's ``os.cpu_count()`` and scheduler affinity;
   cli: ``vit_search_torch.cli.train.main`` in-process with
   ``super_net/tiny.sh``'s own arguments read from the script, only the data
   path, batch 512, 2 epochs of 3 steps, the output directory and the loader
   workers set here: epoch 0, a SIGTERM once its log line is written (the
   run checkpoints in epoch 1 and returns), ``--resume auto`` for the rest
   of epoch 1, then ``--eval`` from the last checkpoint: every loss finite,
   the preemption checkpoint's metadata, the resumed run ending at epoch 1,
   acc1 in [0, 100], and K1/K2 18 and K3/K4 39 launches per train step plus
   K1 18 and K3 39 per eval forward;
7. search, once on each masked-LN route (``stats``: K1 and K5; ``fused``,
   the default: K1 and K3): the same supernet scores an evolutionary
   population (20 random candidates, then one generation of 8 mutations and
   8 crossovers) under the published Tiny budget of 1.7944 GMACs, 8
   candidates per forward over three sub-val batches of 256 synthetic uint8
   images (the last with 128 valid rows); every candidate in the MAC band,
   every score in [0, 100], launches per forward exact, and one chunk's
   logits within tolerance across the two routes; the proposals come from
   the native (C++) generators (``evolver.backend == "native"``), whose
   ``estimate_mac`` must equal the estimator on every candidate, and the
   host seconds per generation of the native and the Python generators are
   printed side by side (``native: ...``);
   dist: two processes spawned from this script on the one card, joined over
   gloo (NCCL refuses two ranks on one card), each with 256 rows of the
   train phase's global batch of 512: two train steps (K1-K4 18/18/39/39
   launches per rank-step) whose losses, grad norms and conv-stem running
   statistics must be within ``DIST_TOL`` of the same two steps in one
   process, both ranks bit for bit equal; the same steps under each planted
   fault (``PLANTED_FAULTS``: the conv stem's batch statistics from a rank's
   own rows, drop-path keeps drawn at a rank's shape) must be caught, by
   the ranks' disagreement or a gap over ``DIST_TOL``; the fused search's
   first generation scored on each rank's share of the sub-val batches
   (K1/K3 18/39 per forward), scores equal to the search phase's; the
   batch's gather and the gradients' all-reduce timed alone; then ``python -m vit_search_torch.cli.launch``
   under a torchrun environment of one process on NCCL, one epoch of two
   steps on the cli phase's folder; its imgs/s is that of two processes
   time-sharing one card, not a multi-card figure;
   study: ``python -m vit_search_torch.tools.accuracy_study`` in a
   subprocess beside the recipes phase below, as users run it, at a smoke
   scale (``STUDY_FLAGS``: 10 classes, 112 px, batch 128, 2 supernet
   epochs, a search of 8 + 4 candidates, two 2-epoch retrains, a 1-epoch finetune at 168 px): the
   port's data tools, ``cli.train``, ``cli.evo_search`` on the checkpoint
   ``cli.train`` wrote, ``cli.train --finetune`` and ``--eval`` on the
   card; it must exit 0 with every summary key, both nets within the
   scaled budget (448.6 M MACs), finite losses and top-1 in [0, 100], and
   render its five sections through the port's ``render_results``; each
   stage's seconds (``tools.study_timing``); then ``tools.gelu_delta`` in
   this process on the retrained winner at 112 px: finite numbers, K1
   launched exactly twice per attention block of the winner at N >= 8
   (stage 3 at 112 px, N = 5, runs the plain version) and no other
   kernel; ``--out`` also gets ``study_summary.json`` and
   ``study_RESULTS.md``;
   recipes: the 24 published scripts of ``scripts/vit-sr-nas`` through
   ``cli.train.main`` and ``cli.evo_search.main`` in this process, each with
   its own arguments (``recipe_argv``; set here: the data, a view of the cli
   phase's folder whose train and val are its sub-train and sub-val; one
   epoch of 2 steps; the loader workers; each search's population, 8 + 8
   candidates, and its MODEL_PATH, the checkpoint its supernet's one-epoch
   run wrote), at each script's own batch, with the working directory at a
   temporary root so that every relative ``models/...`` path resolves as the
   scripts write it: the seven supernets, the six searches on them, the
   reference, searched and Medium nets, the 280 and 392 px finetunes from
   the searched Medium net's ``best_ema`` and the eval of the searched Small
   net's ``best``; every loss finite, every acc1 in [0, 100], every
   candidate in its MAC band, the checkpoints later scripts read present,
   K1-K4 launches exact per train step and per eval or scoring forward,
   peak memory under the card's, one line per script on stderr; then K1/K2
   (and K3/K4 on the supernets) at every stage of the Small supernet, the
   ``sr_tiny_666`` supernet, the reference net and the 280 px finetune at
   their scripts' batches against the plain versions, K2's route by kernel
   name (profiled right after the build, the process's first profiler
   session), and one profiled step of the Small supernet from
   device batches;
8. lab: the attention lab (``vit_search_torch.tools.attn_lab``) at its
   full-width shapes, ``main()`` (K11 against K2, K10 against K1, then each
   timed) and ``main_split()`` (K12a + K12b against K2, then timed), its
   lines on stderr; its errors within tolerance, every kernel launched
   exactly as often as the run calls it, and the lab's kernels against their
   plain versions at the lab's shapes;
9. swin (after the op-level and extra-shape paths; ``--phase swin`` runs
   it alone after the build): the windowed cosine attention
   (``csrc/window_attention.cu``) at SwinV2-B's six stage shapes at 256
   images, out and the three gradients against the plain function with q'
   and k' rounded as the kernels round them (``BF16_TOL``), each direction
   timed beside its bound, the plain version and SDPA with a float
   ``attn_mask``; then SwinV2-B's train step at 256 px and 256 images,
   Mixup/CutMix and erasing, 24 launches of each window-attention record
   and 53 of each dense layer norm a step, its rate and peak;
10. a ``{"kernels": [...]}`` line, each entry with the path whose launches it
   reports (``train``; ``searched``; ``finetune``; ``distill``; ``ops``;
   ``shapes``; ``lab``; ``search``, the stats route; ``search_fused``;
   ``dist``, K1-K4 at a rank's 256 rows, launches of rank 0's train steps
   and scoring forwards; ``recipes``, the launches of the script whose net
   gives the shape, per train step; ``swin``, a SwinV2-B step) and its launches
   per pass of that path (a train step, one call of each op-level entry
   point, one call at one of the extra shapes, one shape of the lab, or a
   scoring forward), then the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. It exits non-zero when no CUDA device is
available, and when it stands alone without the repository.
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

BATCH = 512
EXAMPLE_PER_ARCH = 32
STEPS, WARMUP = 5, 2      # timed and untimed train steps
REPS = 10                 # timed launches per kernel
# (tokens N, embed C, heads H, head_dim D) of the three stages at 224px
STAGES = ((257, 256, 6, 32), (65, 512, 12, 48), (17, 1024, 12, 64))
# attention kernels (forward, backward) by layout
ATTENTION_KERNELS = {"packed": ("attention_qkv_fwd", "attention_qkv_bwd"),
                     "separate": ("attention_fwd", "attention_bwd"),
                     "seq_major": ("attention_qkv_t_fwd", "attention_qkv_t_bwd")}
# per-pass launches: 3 stages x 6 blocks of attention; masked LN twice per
# block, once per SR block (2), once final
ATTENTION, MASKED_LNS = 3 * 6, 3 * 6 * 2 + 2 + 1
KERNEL_NAMES = ("attention_qkv_fwd", "attention_qkv_bwd", "masked_layer_norm_fwd",
                "masked_layer_norm_bwd", "row_sum_sumsq", "attention_fwd", "attention_bwd",
                "attention_qkv_t_fwd", "attention_qkv_t_bwd", "lab_fwd_t", "lab_bwd_t",
                "lab_split_dq", "lab_split_dkv", "layer_norm_fwd", "layer_norm_bwd",
                "window_attention_fwd", "window_attention_bwd", "batch_norm_stats",
                "batch_norm_apply", "batch_norm_bwd")
# SwinV2-B's windowed attention at 256 px, 256 images: (windows B * nW, N,
# heads, shift, the stage's resolution), each stage's unshifted and shifted
# blocks (stages 3 and 4 are one window and never shift)
SWIN_STAGES = ((4096, 256, 4, 0, 64), (4096, 256, 4, 8, 64), (1024, 256, 8, 0, 32),
               (1024, 256, 8, 8, 32), (256, 256, 16, 0, 16), (256, 64, 32, 0, 8))


def per_pass(**counts):
    """Launches of every kernel per pass of a path, 0 unless given."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


# the Conv-BN-ReLU layers of a conv stem (network_def types 4/5)
STEM_NORMS = 3


def with_stem(per: dict, norms: int, train: bool) -> dict:
    """``per`` with the batch norms of a stem of ``norms`` of them: B1's
    statistics and normalize and B2 a train step, B1's normalize alone an
    eval or scoring forward."""
    return dict(per, batch_norm_stats=norms if train else 0, batch_norm_apply=norms,
                batch_norm_bwd=norms if train else 0)


# a train step: K1/K2 on every attention layer, K3/K4 on every masked LN,
# B1/B2 on the conv stem's norms
PER_STEP = with_stem(per_pass(attention_qkv_fwd=ATTENTION, attention_qkv_bwd=ATTENTION,
                              masked_layer_norm_fwd=MASKED_LNS,
                              masked_layer_norm_bwd=MASKED_LNS), STEM_NORMS, True)
# a scoring forward: no backward; the masked LNs take K3 on ln_route="fused"
# (the default) and K5 on ln_route="stats"
PER_FORWARD = {route: with_stem(per_pass(attention_qkv_fwd=ATTENTION,
                                         **{("masked_layer_norm_fwd" if route == "fused"
                                             else "row_sum_sumsq"): MASKED_LNS}),
                                STEM_NORMS, False)
               for route in ("fused", "stats")}
# a pass of the op-level API: one call of each entry point with its backward
# (fused_attention_packed and fused_attention: K6/K7; fused_attention_qkv_t:
# K8/K9)
PER_OPS_PASS = per_pass(attention_fwd=2, attention_bwd=2, attention_qkv_t_fwd=1,
                        attention_qkv_t_bwd=1)
# (label, batch, N, heads, head_dim) past the supernet's shapes: the 392 px
# finetune's stages (medium_img-size@392.sh's network_def, its widest heads)
# and a head dim of 24
FINETUNE_392 = (("392px stage 1", 64, 785, 8, 32), ("392px stage 2", 64, 197, 16, 48),
                ("392px stage 3", 64, 50, 16, 64))
HEAD_DIM_24 = ("head dim 24", BATCH, 257, 8, 24)
# the calls of the `shapes` path, (shape, dtype, layout), each one forward and
# backward through the layout's autograd entry point: the 392 px stages in
# both dtypes packed (K1/K2), stage 1 in bf16 separate (K6/K7) and
# sequence-major (K8/K9), head dim 24 packed
EXTRA_CALLS = ([(shape, dtype, "packed") for shape in FINETUNE_392
                for dtype in ("bfloat16", "float32")]
               + [(FINETUNE_392[0], "bfloat16", layout) for layout in ("separate", "seq_major")]
               + [(HEAD_DIM_24, "bfloat16", "packed")])
# launches of each kernel per call that runs it
PER_SHAPES_CALL = per_pass(**{name: 1 for names in ATTENTION_KERNELS.values() for name in names})
# a shape of the attention lab, main() then main_split(): each variant is
# called once to compare, once to warm up, then three times LAB_ITERS times;
# K1/K2/K10/K11 are main()'s base and T, K2 is also main_split()'s base
LAB_ITERS = 30
LAB_CALLS = 2 + 3 * LAB_ITERS
PER_LAB_SHAPE = per_pass(attention_qkv_fwd=LAB_CALLS, attention_qkv_bwd=2 * LAB_CALLS,
                         lab_fwd_t=LAB_CALLS, lab_bwd_t=LAB_CALLS, lab_split_dq=LAB_CALLS,
                         lab_split_dkv=LAB_CALLS)
# the searched and finetune paths: searched_net/tiny.sh (ViT-ResNAS-Tiny,
# dense, 16 attention layers) at the train phase's batch (the script's 1024
# halved, as the supernet's), and finetune/medium_img-size@392.sh
# (ViT-ResNAS-Medium, 20 attention layers) at 64 images (the script's 256 is
# per host of four cards), both with random erasing and the EMA on
SEARCHED_MODEL = "flexible_vit_sr_patch14_224_patch_output"
FINETUNE_MODEL = "flexible_vit_sr_patch14_392_patch_output"
FINETUNE_BATCH = 64
EMA_DECAY = 0.99996
ERASING = {"erasing_prob": 0.25, "erasing_mode": "pixel"}
# (their layer norms on K3/K4's dense mode: 2 x 16 + 2 + 1 and 2 x 20 + 2 +
# 1, ``dense_lns``)
PER_SEARCHED_STEP = with_stem(per_pass(attention_qkv_fwd=16, attention_qkv_bwd=16,
                                       layer_norm_fwd=35, layer_norm_bwd=35), STEM_NORMS, True)
PER_FINETUNE_STEP = with_stem(per_pass(attention_qkv_fwd=20, attention_qkv_bwd=20,
                                       layer_norm_fwd=43, layer_norm_bwd=43), STEM_NORMS, True)
# the mixup path: super_net/no_distill/tiny_mh.sh, which trains the supernet
# with timm Mixup/CutMix (no --use-patch-mixup), its network_def read from
# the script; the train step's K1-K4 launches (K1/K2 18, K3/K4 39) and, its
# stem linear, no batch norm
PER_MIXUP_STEP = with_stem(PER_STEP, 0, True)
MIXUP_SCRIPT = "scripts/vit-sr-nas/super_net/no_distill/tiny_mh.sh"
MIXUP_MODEL = "flexible_vit_sr_patch14_224_supernet"
MIXUP = {"mixup_mode": "mixup", "mixup_alpha": 0.8, "cutmix_alpha": 1.0,
         "mixup_switch_prob": 0.5, "mixup_prob": 1.0, "mixup_elem_mode": "batch"}
# the distill path: the DeiT-S distillation recipe (facebookresearch/deit
# README: deit_small_distilled_patch16_224 --distillation-type hard
# --teacher-model regnety_160) at the batch the other paths take (DeiT's
# global 1024 halved); 12 blocks of 6 heads of 64 at N = 196 + 2 tokens, 25
# dense layer norms (no SR block); the teacher's batch norms in eval mode,
# B1's normalize once each a step (counted from the teacher)
DISTILL_MODEL = "deit_small_distill_patch16_224"
TEACHER_MODEL = "regnety_160_upsample"
PER_DISTILL_STEP = per_pass(attention_qkv_fwd=12, attention_qkv_bwd=12, layer_norm_fwd=25,
                            layer_norm_bwd=25)
DISTILL_SHAPES = (("DeiT-S", BATCH, 198, 6, 64),)
# ViT-ResNAS-Medium's stages at 224 px, (N, C), at searched_net/medium_mac@4.6G.sh's
# batch: the shapes of its dense layer norms (K3/K4's dense mode)
MEDIUM_STAGES = ((257, 240), (65, 640), (17, 880))
MEDIUM_BATCH = 1024
# (N, C) of the 392 px finetune's three stages, at its script's batch
MEDIUM_392_STAGES = ((785, 240), (197, 640), (50, 880))
MEDIUM_392_BATCH = 256
# B1/B2 at the cells' conv stem shapes: (label, batch, image px, train, the
# path whose launches the entry reports): the train step at 224 px
# (tiny_supernet.train, medium.train) and at 392 px (medium.finetune392), and
# a scoring forward (tiny_supernet.search); 24 channels at half resolution
STEM_CASES = (("train 224px", 1024, 224, True, "train"),
              ("train 392px", 256, 392, True, "finetune"),
              ("eval 224px", 2048, 224, False, "search_fused"))
STEM_CHANNELS = 24
# loader and cli: super_net/tiny.sh on a synthetic image folder of 1000
# classes (the heads keep their published width), 4 train images per class
# at 256 px, 1 per class held out as the sub-val
SUPERNET_SCRIPT = "scripts/vit-sr-nas/super_net/tiny.sh"
FOLDER_CLASSES, FOLDER_TRAIN, FOLDER_HOLDOUT, FOLDER_SIZE = 1000, 4, 1, 256
LOADER_AUGMENT = "rand-m9-mstd0.5-inc1"   # the CLI's --aa default, which tiny.sh keeps
CLI_EPOCHS, CLI_STEPS = 2, 3
# the small net's distill check: dropout rate, and the narrow teacher behind
# a 112 -> 96 px resize
REF_DROPOUT = 0.1
REF_TEACHER = {"target_size": 96, "widths": (32, 64), "depths": (1, 2), "group_width": 16,
               "stem_width": 16, "num_classes": 10}
# (label, batch, N, heads, head_dim): the searched Tiny net's stages at their
# widest heads; the finetune's are FINETUNE_392
SEARCHED_SHAPES = (("searched stage 1", BATCH, 257, 4, 32),
                   ("searched stage 2", BATCH, 65, 10, 48),
                   ("searched stage 3", BATCH, 17, 10, 64))
# search: --val-bs and --arch-batch of cli/evo_search.py, the Tiny budget of
# scripts/vit-sr-nas/evolutionary_search/tiny.sh; population cut to 20 + 16
VAL_BATCH, ARCH_BATCH, VAL_BATCHES, LAST_VALID = 256, 8, 3, 128
SEARCH_BATCH = ARCH_BATCH * VAL_BATCH    # images per scoring forward
SEARCH_MODEL = "flexible_vit_sr_patch14_224_patch_output_supernet"
TINY_BUDGET = 1.7944e9
POPULATION, PARENTS, MUTATIONS, MUTATE_PROB = 20, 8, 8, 0.3
# the reference search (tiny.sh, evo_search.py defaults): 500 random, then 19
# generations of 75 mutations + 75 crossovers, on 25 images x 1000 classes
REFERENCE_SEARCH = {"first": 500, "generations": 19, "per_generation": 150,
                    "sub_val_images": 25000}
# dist: the train phase's step and the search phase's scoring in two processes
# on the one card over gloo (NCCL refuses two ranks on one card), each rank
# DIST_BATCH rows of the global BATCH; then cli.launch on NCCL alone
DIST_PROCS, DIST_STEPS = 2, 2
DIST_BATCH = BATCH // DIST_PROCS
# two processes against one on the same card and data differ only in the
# order of the sums (the gradients', the conv stem's batch statistics'):
# relative limits on the losses, the grad norms and the conv stem's running
# statistics (by norm), each near the geometric mean of the sound run's gap
# and the smallest planted fault's (``PLANTED_FAULTS``, each of which must be
# caught). On an H100 the sound run's gaps were 1.2e-5 / 3.6e-4 / 2.2e-6;
# local drop-path keeps gave 1.1e-3 / 6.6e-3 / 8.3e-5; local batch
# statistics 8.7e-5 / 5.3e-4 / 5.3e-2, and ranks that disagree
DIST_TOL = {"loss": 1e-4, "grad_norm": 1.5e-3, "bn_stats": 1e-5}
LAUNCH_STEPS = 2
# study: the port's accuracy study (python -m vit_search_torch.tools.accuracy_study)
# at a smoke scale: 10 classes of 64 train images (16 held out) and 26 val
# images (260, so gelu_delta finds its 256), at 112 px (patch_len 2; the
# finetune at 168 px), every stage of the pipeline, then gelu_delta in this
# process on the retrained winner. The budget is the Tiny one scaled to the
# 112 px token grid, as the study scales it.
STUDY_SIZE, STUDY_FINETUNE_SIZE = 112, 168
STUDY_FLAGS = {"--classes": "10", "--train-per-class": "64", "--val-per-class": "26",
               "--holdout-per-class": "16", "--input-size": str(STUDY_SIZE),
               "--batch-size": "128", "--supernet-epochs": "2", "--mask-warmup-epochs": "1",
               "--retrain-epochs": "2", "--finetune-epochs": "1", "--popu": "8",
               "--search-iters": "2", "--parent-size": "4", "--mutate-size": "2"}
STUDY_BUDGET = TINY_BUDGET * (STUDY_SIZE / 224) ** 2
STUDY_TIMEOUT_S = 600
STUDY_KEYS = ("supernet_curve", "search_best_per_iter", "winner_def", "winner_mac",
              "winner_curve", "winner_final_acc1", "random_def", "random_mac", "random_curve",
              "random_final_acc1", "finetune_size", "finetune_curve", "eval_only")
STUDY_SECTIONS = ("## 1. Supernet training learns", "## 2. Search improves fitness",
                  "## 3. Searched net vs same-MAC controls", "## 4. Higher-resolution finetune",
                  "## 5. Standalone `--eval`")
# recipes: the 24 published scripts of RECIPE_DIR, each through the port's CLI
# in this process with its own arguments, in an order where every script runs
# after the one whose checkpoint it reads. Set here: IMAGENET_PATH (a view of
# the cli phase's folder whose train and val are its sub-train and sub-val),
# MODEL_PATH (the searches: RECIPE_CHECKPOINT in the directory the script
# names, which a one-epoch run writes where the script's default names epoch
# 119's snapshot), one epoch of RECIPE_STEPS steps, the loader workers, and
# each search's population (RECIPE_SEARCH); the working directory is a
# temporary root, so every relative models/... path resolves as the scripts
# write it
RECIPE_DIR = "scripts/vit-sr-nas"
RECIPES = ("super_net/tiny.sh", "super_net/small.sh", "super_net/no_distill/small_conv-patch.sh",
           "super_net/no_distill/small_flexible-conv-patch.sh", "super_net/no_distill/tiny.sh",
           "super_net/no_distill/tiny_conv-patch.sh", "super_net/no_distill/tiny_mh.sh",
           "evolutionary_search/tiny.sh", "evolutionary_search/small_mac@2.9G.sh",
           "evolutionary_search/medium_mac@4.6G.sh",
           "evolutionary_search/no_distill/small_flexible-conv-patch.sh",
           "evolutionary_search/no_distill/tiny_666.sh",
           "evolutionary_search/no_distill/tiny_conv-patch.sh",
           "reference_net/tiny.sh", "reference_net/tiny_conv_patchmixup.sh",
           "searched_net/tiny.sh", "searched_net/no_distill/tiny_conv-patch.sh",
           "searched_net/small_mac@2.9G.sh", "searched_net/no_distill/small_conv-patch_mac@2.9G.sh",
           "searched_net/medium_mac@4.6G.sh",
           "searched_net/no_distill/small_conv-patch_mac@4.6G.sh",
           "finetune/medium_img-size@280.sh", "finetune/medium_img-size@392.sh",
           "eval/small_mac@2.9G.sh")
RECIPE_EPOCHS, RECIPE_STEPS = 1, 2
RECIPE_CHECKPOINT = "checkpoint"
RECIPE_SEARCH = {"--init-popu-size": "8", "--search-iter": "2", "--parent-size": "4",
                 "--mutate-size": "4"}
# the flags the recipes phase may set; any other argument is the script's own
RECIPE_OVERRIDES = ("--data-path", "--model-path", "--epochs", "--max-steps-per-epoch",
                    "--num_workers", *RECIPE_SEARCH, "--batch-size", "--val-bs")
# a script whose own batch one card cannot hold runs at the largest power of
# two that fits (script -> batch); none so far
RECIPE_BATCH_CUTS: dict = {}
# the recipes whose kernel shapes the kernel phase checks under the path
# ``recipes`` (read from each script's network_def and token count): K1/K2
# at every stage's widest heads, K3/K4 (supernets) at every stage's width
RECIPE_KERNEL_SCRIPTS = (("Small supernet", "super_net/small.sh"),
                         ("sr_tiny_666 supernet", "super_net/no_distill/tiny.sh"),
                         ("reference net", "reference_net/tiny.sh"),
                         ("280 px finetune", "finetune/medium_img-size@280.sh"))
COMM_REPS = 5
# H100 SXM data sheet: HBM bytes/s; dense bf16 tensor-core and f32 flop/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
L2_BYTES = 50 * 2**20
# tolerance: |kernel - plain| <= ATOL * max|plain| + RTOL * |plain|
BF16_TOL = (2e-2, 2e-2)
F32_SUM_TOL = (1e-3, 1e-3)   # gw/gb: the order of the sum differs
F32_TOL = 1e-4               # float32 attention (CUDA cores): atol and rtol
STATS_TOL = (1e-4, 1e-4)
# B1/B2's ReLU: where the statistics are summed in another order, a float32
# pre-activation z moved by at most 2 ulps of its channel's max|z| (a CPU
# model of two orders at the stem's shape), so one within KINK_ULPS such ulps
# of 0 may fall on either side; its dx is not compared, and such elements
# may be at most KINK_SHARE of the activation
KINK_ULPS = 8
KINK_SHARE = 1e-4
# K3/K4's yardstick: PyTorch's layer norm is the function with a full mask
LN_LIBRARY_CALL = "F.layer_norm (dense: the full-mask case of the function)"
# the small net in bf16, card against CPU: on the CPU alone bf16 moves the
# logits by 0.9% of their largest value from f32, the loss by 1.7e-4 and the
# gradient norm by 6.6e-4 (relative); the card rounds at other places
# (tensor-core attention, cuBLAS, cuDNN), so allow about three times that
# for the logits and more for the two scalars
REF_NET_BF16_TOL = {"logits": (3e-2, 3e-2), "loss": 2e-3, "grad_norm": 5e-3}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, args: tuple, reps: int) -> float:
    """Per-launch device time of ``fn(*args)``: the launches are captured in
    one CUDA graph and replayed, so the wrapper's host overhead between them
    drops out, and they rotate over copies of the tensor arguments that
    together exceed twice the L2 cache, so each launch reads from HBM."""
    import torch
    size = nbytes(*(a for a in args if isinstance(a, torch.Tensor)))
    copies = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                       for _ in range(math.ceil(2 * L2_BYTES / size))]
    reps = max(reps, len(copies))
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fn(*copies[i % len(copies)])
    ms = time_ms(graph.replay, 3, warmup=1) / reps
    del graph, copies
    return ms


# kernel classes of a profile, matched in order on the kernel's name
KERNEL_CLASSES = (("attention forward (K1/K6/K8)", ("attn_fwd_kernel",)),
                  ("attention backward (K2/K7/K9)", ("attn_bwd_", "attn_split_")),
                  ("K5 row statistics", ("row_stats_kernel",)),
                  ("K3/K4 masked LN", ("masked_ln_",)),
                  ("convolution", ("fprop", "conv", "cudnn")),
                  ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
                  ("reduction", ("reduce",)),
                  ("elementwise and copies", ("elementwise", "copy")))


def profile_kernels(fn, top: int = 12):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    ``(device-busy ms, wall ms, {class: ms}, [(name, ms, calls), ...])``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    classes: dict = {}
    for name, ms, _ in rows:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    return sum(r[1] for r in rows), wall_ms, classes, rows[:top]


def ptxas_summary(report: str, prefix: str):
    """``[{kernel, registers, spill_stores, spill_loads}]`` for each kernel of
    ``nvcc -Xptxas -v`` output named ``<prefix>...kernel``, with its element
    type, chunks per lane and mode (masked or dense) read from the mangled
    template arguments."""
    import re

    pattern = re.compile(re.escape(prefix) + r"[a-z_]*kernel(?:I(13__nv_bfloat16|f)"
                         r"(?:Li(\d+)E)?(?:Lb([01])E)?E)?")
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = pattern.search(m.group(1))
            cur = None
            if k:
                label = k.group(0).split("I")[0] if k.group(1) else k.group(0)
                if k.group(1):
                    label += " bf16" if k.group(1) == "13__nv_bfloat16" else " f32"
                if k.group(2):
                    label += f" CPL {k.group(2)}"
                if k.group(3) == "1":
                    label += " dense"
                cur = {"kernel": label, "registers": None, "spill_stores": 0,
                       "spill_loads": 0}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def compare(name: str, got, want, tol, floor: float = 0.0) -> float:
    """Max abs error; raises if an element is outside the tolerance
    ``max(atol * max|want|, floor) + rtol * |want|``."""
    import torch
    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    atol, rtol = tol
    bound = torch.clamp(atol * want.abs().max(), min=floor) + rtol * want.abs()
    worst = float((err - bound).max())
    max_err = float(err.max())
    if worst > 0:
        raise AssertionError(f"{name}: max abs err {max_err:.3e} outside tolerance "
                             f"atol={atol}*max|ref| rtol={rtol}")
    return max_err


def relu_kink(name: str, z):
    """The elements of a float32 (B, C, H, W) pre-activation ``z`` within
    ``KINK_ULPS`` ulps of their channel's max|z| of 0; raises where they are
    more than ``KINK_SHARE`` of ``z``."""
    import torch
    top = z.detach().abs().amax(dim=(0, 2, 3), keepdim=True)
    band = z.detach().abs() <= KINK_ULPS * torch.finfo(torch.float32).eps * top
    share = float(band.float().mean())
    if share > KINK_SHARE:
        raise AssertionError(f"{name}: {share:.3e} of the pre-activation lies within "
                             f"{KINK_ULPS} ulps of 0, more than {KINK_SHARE}")
    return band


def check_relu_norm(what: str, got: tuple, want: tuple, z, tol=BF16_TOL) -> dict:
    """A batch norm with the ReLU against the plain ops: ``got`` and ``want``
    each ``(y, running_mean, running_var, (dx, dw, db))``, the gradients empty
    in eval mode, ``want`` with the plain ops' own ReLU, ``z`` their float32
    pre-activation. y within ``tol`` everywhere; the running statistics
    within ``STATS_TOL``, dw and db within ``F32_SUM_TOL``, dx within ``tol``
    outside :func:`relu_kink`'s band. The largest error of each."""
    import torch
    band = relu_kink(what, z)
    y, rm, rv, grads = got
    ry, rrm, rrv, rgrads = want
    errs = {"y": compare(f"{what} y", y, ry, tol)}
    if grads:
        errs["running"] = max(compare(f"{what} running mean", rm, rrm, STATS_TOL),
                              compare(f"{what} running var", rv, rrv, STATS_TOL))
        errs["dx"] = compare(f"{what} dx", torch.where(band, rgrads[0], grads[0]), rgrads[0],
                             tol)
        errs["dw_db"] = max(compare(f"{what} dw", grads[1], rgrads[1], F32_SUM_TOL),
                            compare(f"{what} db", grads[2], rgrads[2], F32_SUM_TOL))
    return errs


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_layout(layout: str, qkv, do, h: int):
    """One layout's form of a ``(B, N, 3W)`` projection and its ``(B, N, W)``
    cotangent: ``(inputs, cotangent, ops, views, cotangent_view)``. ``ops``
    holds the autograd entry point, the kernels' wrappers and the plain
    versions, each called as ``fn(*inputs, scale, h)`` (backward:
    ``fn(*inputs, cotangent, scale, h)``); ``views(inputs)`` gives ``(B, H,
    N, D)`` views of q, k and v for SDPA, ``cotangent_view`` the cotangent's."""
    from vit_search_torch.ops import attention as A

    b, n, w3 = qkv.shape
    d = w3 // (3 * h)
    if layout == "packed":
        ins, g = (qkv,), do
        ops = (A.fused_attention_qkv, A.attention_qkv_fwd_cuda, A.attention_qkv_bwd_cuda,
               A.attention_qkv_plain, A.attention_qkv_bwd_plain)

        def views(t):
            return t[0].view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        g_view = do.view(b, n, h, d).transpose(1, 2)
    elif layout == "separate":
        ins, g = tuple(t.contiguous() for t in qkv.split(w3 // 3, dim=2)), do
        ops = (A.fused_attention_packed, A.attention_fwd_cuda, A.attention_bwd_cuda,
               A.attention_plain, A.attention_bwd_plain)

        def views(t):
            return tuple(x.view(b, n, h, d).transpose(1, 2) for x in t)
        g_view = do.view(b, n, h, d).transpose(1, 2)
    else:
        ins, g = (qkv.transpose(0, 1).contiguous(),), do.transpose(0, 1).contiguous()
        ops = (A.fused_attention_qkv_t, A.attention_qkv_t_fwd_cuda, A.attention_qkv_t_bwd_cuda,
               A.attention_qkv_t_plain, A.attention_qkv_t_bwd_plain)

        def views(t):
            return t[0].view(n, b, 3, h, d).permute(2, 1, 3, 0, 4).unbind(0)
        g_view = g.view(n, b, h, d).permute(1, 2, 0, 3)
    return ins, g, ops, views, g_view


def flat(grads):
    """A backward's result as one tensor (three cotangents side by side)."""
    import torch
    return torch.cat(grads, dim=2) if isinstance(grads, tuple) else grads


def check_attention(stage, reps: int, batch: int, path: str, backward: bool,
                    layout: str = "packed", nhd=None, dtype: str = "bfloat16"):
    """The attention kernels of ``layout`` (K1/K2 packed, K6/K7 separate,
    K8/K9 sequence-major; the backward where ``backward``) against their
    plain versions at ``batch``: at stage ``stage`` (0-2) of the supernet, or
    at ``nhd = (N, heads, head_dim)`` under the label ``stage``."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import attention as A

    if nhd is None:
        n, _, h, d = STAGES[stage]
        stage, seed = stage + 1, stage
    else:
        n, h, d = nhd
        seed = n + d
    b, w = batch, h * d
    scale = d ** -0.5
    torch_dtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * w, device="cuda", generator=gen).to(torch_dtype)
    do = torch.randn(b, n, w, device="cuda", generator=gen).to(torch_dtype)
    ins, g, (entry, fwd_cuda, bwd_cuda, fwd_plain, bwd_plain), views, g_view = attention_layout(
        layout, qkv, do, h)
    del qkv, do
    fwd_name, bwd_name = ATTENTION_KERNELS[layout]
    shape = {"B": b, "N": n, "H": h, "D": d, "dtype": dtype, "layout": layout}
    if dtype == "bfloat16":
        tol, peak = BF16_TOL, PEAK_BF16
        tolerance = f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)"
        if backward:
            shape["bwd_route"] = "split" if A.backward_is_split(n, d) else "one launch"
    else:
        tol, peak = (F32_TOL, F32_TOL), PEAK_F32
        tolerance = f"abs <= {F32_TOL}*max|ref| + {F32_TOL}*|ref| (f32, CUDA cores)"
    what = f"{fwd_name} stage {stage} B={b}"

    # through autograd, as a caller uses it: the forward launches the forward
    # kernel, the backward the backward kernel; a scoring forward runs under
    # no_grad
    leaves = tuple(t.clone().requires_grad_(backward) for t in ins)
    with torch.set_grad_enabled(backward):
        out = entry(*leaves, scale, h)
    if backward:
        grads = torch.autograd.grad(out, leaves, g)
        grads = grads[0] if len(grads) == 1 else grads
    torch.cuda.synchronize()
    ref_out = fwd_plain(*ins, scale, h)
    err_fwd = compare(what, out, ref_out, tol)
    del out, leaves

    fwd_call_ms = time_ms(lambda: fwd_cuda(*ins, scale, h), reps)
    fwd_ms = graph_ms(fwd_cuda, (*ins, scale, h), reps)
    plain_fwd_ms = time_ms(lambda: fwd_plain(*ins, scale, h), reps)

    # PyTorch's own attention on views of the same tensors, as a yardstick only
    sleaves = tuple(t.clone().requires_grad_(backward) for t in ins)
    q, k, v = views(sleaves)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    with torch.no_grad():
        lib_fwd_ms = time_ms(sdpa, reps)
    bfwd = bound(nbytes(*ins, ref_out), 4.0 * b * h * n * n * d, peak)
    entries = [dict(name=fwd_name, stage=stage, shape=shape, path=path,
                    max_abs_err=err_fwd, tolerance=tolerance, ms=fwd_ms, call_ms=fwd_call_ms,
                    plain_ms=plain_fwd_ms, bound_ms=bfwd[0], bound_by=bfwd[1],
                    library_ms=lib_fwd_ms,
                    library_call="F.scaled_dot_product_attention forward")]
    if not backward:
        return entries

    ref_grads = bwd_plain(*ins, g, scale, h)
    err_bwd = compare(f"{bwd_name} stage {stage} B={b}", flat(grads), flat(ref_grads), tol)
    bwd_call_ms = time_ms(lambda: bwd_cuda(*ins, g, scale, h), reps)
    bwd_ms = graph_ms(bwd_cuda, (*ins, g, scale, h), reps)
    plain_bwd_ms = time_ms(lambda: bwd_plain(*ins, g, scale, h), reps)
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa(), sleaves, g_view), reps)
    bbwd = bound(nbytes(*ins, g, flat(ref_grads)), 10.0 * b * h * n * n * d, peak)
    entries.append(dict(
        name=bwd_name, stage=stage, shape=shape, path=path,
        max_abs_err=err_bwd, tolerance=tolerance, ms=bwd_ms, call_ms=bwd_call_ms,
        plain_ms=plain_bwd_ms, bound_ms=bbwd[0], bound_by=bbwd[1],
        library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
        library_call="F.scaled_dot_product_attention (forward+backward) - forward"))
    return entries


def masked_ln_inputs(stage: int, batch: int, nc=None):
    """Seeded bf16 ``(x, mask, weight, bias, g)`` at stage ``stage`` (0-2)
    of the supernet, or at ``nc = (N, C)`` seeded by ``stage``, a mask per
    example of one of five widths."""
    import numpy as np
    import torch
    from vit_search_torch.ops.masking import make_channel_mask

    n, c = nc or STAGES[stage][:2]
    gen = torch.Generator(device="cuda").manual_seed(100 + stage)
    widths = np.array([c, c * 7 // 8, c * 3 // 4, c * 11 // 16, c * 5 // 8])
    counts = torch.as_tensor(np.random.default_rng(stage).choice(widths, batch), device="cuda")
    mask = make_channel_mask(counts, c, dtype=torch.bfloat16)
    x = (torch.randn(batch, n, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    g = torch.randn(batch, n, c, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)
    return x * mask, mask, w, bias, g


def check_masked_ln(stage: int, reps: int, batch: int, path: str, backward: bool, nc=None):
    """K3 (and K4 where ``backward``) against the plain versions at ``batch``,
    at stage ``stage`` (0-2) of the supernet or at ``nc = (N, C)``."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import kernels
    from vit_search_torch.ops import masked_layer_norm as M

    n, c = nc or STAGES[stage][:2]
    b = batch
    x, mask, w, bias, g = masked_ln_inputs(stage, b, nc)
    shape = {"B": b, "N": n, "C": c, "dtype": "bfloat16"}

    y, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
    torch.cuda.synchronize()
    ref_y, ref_stats = M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6)
    err_fwd = max(compare(f"K3 y stage {stage + 1} B={b}", y, ref_y, BF16_TOL),
                  compare(f"K3 stats stage {stage + 1} B={b}", stats, ref_stats, STATS_TOL))
    fwd_call_ms = time_ms(lambda: M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6), reps)
    fwd_ms = graph_ms(M.masked_ln_fwd_cuda, (x, mask, w, bias, 1e-6), reps)
    plain_fwd_ms = time_ms(lambda: M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6), reps)
    bfwd = bound(nbytes(x, mask, w, bias, ref_y, ref_stats), 10.0 * x.numel(), PEAK_F32)

    # PyTorch's dense layer norm on the same tensor, as a yardstick only: the
    # full-mask case of the function
    lx = x.clone().requires_grad_(backward)
    lw = w.to(x.dtype).requires_grad_(backward)
    lb = bias.to(x.dtype).requires_grad_(backward)

    def layer_norm():
        return F.layer_norm(lx, (c,), lw, lb, 1e-6)

    with torch.no_grad():
        lib_fwd_ms = time_ms(layer_norm, reps)
    entries = [dict(name="masked_layer_norm_fwd", stage=stage + 1, stage_index=stage,
                    shape=shape, path=path,
                    max_abs_err=err_fwd,
                    tolerance=(f"y: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                               f"stats: {STATS_TOL}"),
                    ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0],
                    bound_by=bfwd[1], library_ms=lib_fwd_ms,
                    library_call=LN_LIBRARY_CALL + " forward",
                    plan=M.launch_plan(b * n, n, c, x.element_size(), False, True,
                                       kernels.num_sms(x), False).__dict__)]
    if not backward:
        return entries

    gx, gw, gb = M.masked_ln_bwd_cuda(x, mask, w, stats, g)
    torch.cuda.synchronize()
    ref_gx, ref_gw, ref_gb = M.masked_ln_bwd_plain(x, mask, w, ref_stats, g)
    err_bwd = compare(f"K4 gx stage {stage + 1} B={b}", gx, ref_gx, BF16_TOL)
    err_sum = max(compare(f"K4 gw stage {stage + 1} B={b}", gw, ref_gw, F32_SUM_TOL),
                  compare(f"K4 gb stage {stage + 1} B={b}", gb, ref_gb, F32_SUM_TOL))
    bwd_call_ms = time_ms(lambda: M.masked_ln_bwd_cuda(x, mask, w, stats, g), reps)
    bwd_ms = graph_ms(M.masked_ln_bwd_cuda, (x, mask, w, stats, g), reps)
    plain_bwd_ms = time_ms(lambda: M.masked_ln_bwd_plain(x, mask, w, stats, g), reps)
    bbwd = bound(nbytes(x, mask, w, ref_stats, g, ref_gx, ref_gw, ref_gb),
                 14.0 * x.numel(), PEAK_F32)
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(layer_norm(), (lx, lw, lb), g), reps)
    entries.append(dict(
        name="masked_layer_norm_bwd", stage=stage + 1, stage_index=stage, shape=shape,
        path=path,
        max_abs_err=err_bwd, max_abs_err_gw_gb=err_sum,
        tolerance=(f"gx: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                   f"gw/gb: {F32_SUM_TOL}"),
        ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_bwd_ms, bound_ms=bbwd[0],
        bound_by=bbwd[1], library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
        library_call=LN_LIBRARY_CALL + " (forward+backward) - forward",
        plan=M.launch_plan(b * n, n, c, x.element_size(), False, True, kernels.num_sms(x),
                           True).__dict__))
    return entries


def k4_launches(entries, reps: int) -> None:
    """K4 is two launches: the rows (gx and a partial of gw, gb per block),
    then the partials' fold. Device ms of each per call, by kernel name
    (``torch.profiler``), into K4's train-batch entries as ``rows_ms`` and
    ``fold_ms``. Run last: once the profiler has run, later host launches
    are slower."""
    from vit_search_torch.ops import masked_layer_norm as M

    for e in entries:
        if e["name"] != "masked_layer_norm_bwd":
            continue
        x, mask, w, bias, g = masked_ln_inputs(e["stage_index"], e["shape"]["B"],
                                               (e["shape"]["N"], e["shape"]["C"]))
        _, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
        _, _, _, top = profile_kernels(
            lambda: [M.masked_ln_bwd_cuda(x, mask, w, stats, g) for _ in range(reps)], top=50)
        split = {("fold" if "fold" in name else "rows"): ms / reps
                 for name, ms, _ in top if "masked_ln_bwd" in name}
        e.update(rows_ms=split.get("rows"), fold_ms=split.get("fold"))
        log(f"K4 stage {e['stage']} B={e['shape']['B']}: rows {split.get('rows', 0):.4f} ms + "
            f"fold {split.get('fold', 0):.4f} ms per call (profiler); graph {e['ms']:.4f} ms")


def check_layer_norm(label: str, n: int, c: int, reps: int, batch: int, path: str):
    """K3 and K4 in their dense mode (the layer norm of a net without masks)
    at ``(batch, n, c)`` against the plain dense function in float32; ``plain_ms``
    is that function as the port ran it before (autograd through float32
    PyTorch ops), ``library_ms`` ``F.layer_norm``, which the port never calls."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import kernels
    from vit_search_torch.ops import masked_layer_norm as M

    b = batch
    gen = torch.Generator(device="cuda").manual_seed(600 + c)
    x = (torch.randn(b, n, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    g = torch.randn(b, n, c, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)
    shape = {"B": b, "N": n, "C": c, "dtype": "bfloat16"}
    what = f"dense LN {label} (B, N, C) = ({b}, {n}, {c})"

    y, stats = M.layer_norm_fwd_cuda(x, w, bias, 1e-6)
    gx, gw, gb = M.layer_norm_bwd_cuda(x, w, stats, g)
    torch.cuda.synchronize()
    xf, wf, bf = (t.detach().float().requires_grad_() for t in (x, w, bias))
    ref_y = M.layer_norm_plain(xf, wf, bf, 1e-6)
    ref_gx, ref_gw, ref_gb = torch.autograd.grad(ref_y, (xf, wf, bf), g.float())
    with torch.no_grad():
        mu = xf.mean(-1, keepdim=True)
        ref_stats = torch.cat([mu, torch.rsqrt((xf - mu).square().mean(-1, keepdim=True)
                                               + 1e-6)], -1)
    err_fwd = max(compare(f"{what} y", y, ref_y, BF16_TOL),
                  compare(f"{what} stats", stats, ref_stats, STATS_TOL))
    err_bwd = compare(f"{what} gx", gx, ref_gx, BF16_TOL)
    err_sum = max(compare(f"{what} gw", gw, ref_gw, F32_SUM_TOL),
                  compare(f"{what} gb", gb, ref_gb, F32_SUM_TOL))
    del xf, wf, bf, ref_y, ref_gx, ref_stats, mu

    fwd_ms = graph_ms(M.layer_norm_fwd_cuda, (x, w, bias, 1e-6), reps)
    bwd_ms = graph_ms(M.layer_norm_bwd_cuda, (x, w, stats, g), reps)
    fwd_call_ms = time_ms(lambda: M.layer_norm_fwd_cuda(x, w, bias, 1e-6), reps)
    bwd_call_ms = time_ms(lambda: M.layer_norm_bwd_cuda(x, w, stats, g), reps)
    px, pw, pb = (t.detach().clone().requires_grad_() for t in (x, w, bias))

    def plain():
        return M.layer_norm_plain(px, pw, pb, 1e-6)

    with torch.no_grad():
        plain_fwd_ms = time_ms(plain, reps)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(plain(), (px, pw, pb), g),
                           reps) - plain_fwd_ms
    lx, lw, lb = x.clone().requires_grad_(), w.to(x.dtype).requires_grad_(), \
        bias.to(x.dtype).requires_grad_()

    def layer_norm():
        return F.layer_norm(lx, (c,), lw, lb, 1e-6)

    with torch.no_grad():
        lib_fwd_ms = time_ms(layer_norm, reps)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(layer_norm(), (lx, lw, lb), g),
                         reps) - lib_fwd_ms
    bfwd = bound(nbytes(x, w, bias, y, stats), 10.0 * x.numel(), PEAK_F32)
    bbwd = bound(nbytes(x, w, stats, g, gx, gw, gb), 14.0 * x.numel(), PEAK_F32)
    sms = kernels.num_sms(x)
    plans = [M.launch_plan(b * n, n, c, 2, False, True, sms, bwd, dense=True).__dict__
             for bwd in (False, True)]
    log(f"{what}: K3 dense {fwd_ms:.4f} ms, K4 dense {bwd_ms:.4f} ms (bounds {bfwd[0]:.4f} / "
        f"{bbwd[0]:.4f}); plain {plain_fwd_ms:.3f} / {plain_bwd_ms:.3f} ms; F.layer_norm "
        f"{lib_fwd_ms:.4f} / {lib_bwd_ms:.4f} ms")
    return [dict(name="layer_norm_fwd", stage=label, shape=shape, path=path,
                 max_abs_err=err_fwd,
                 tolerance=(f"y: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                            f"stats: {STATS_TOL}"),
                 ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0],
                 bound_by=bfwd[1], library_ms=lib_fwd_ms,
                 library_call="F.layer_norm forward (bf16 weight and bias)", plan=plans[0]),
            dict(name="layer_norm_bwd", stage=label, shape=shape, path=path,
                 max_abs_err=err_bwd, max_abs_err_gw_gb=err_sum,
                 tolerance=(f"gx: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                            f"gw/gb: {F32_SUM_TOL}"),
                 ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_bwd_ms, bound_ms=bbwd[0],
                 bound_by=bbwd[1], library_ms=lib_bwd_ms,
                 library_call="F.layer_norm (forward+backward) - forward", plan=plans[1])]


def stem_activation(batch: int, img: int, seed: int):
    """A stem norm's input as the stem makes it: ``conv1`` (3x3, stride 2,
    bf16) of NHWC images viewed as NCHW, in the layout the convolution
    returns."""
    import torch
    from vit_search_torch.models.patch_embed import ConvBnAct, conv2d

    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(batch, img, img, 3, device="cuda", generator=gen)
    layer = ConvBnAct(3, STEM_CHANNELS, 2, torch.bfloat16,
                      torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        return conv2d(images.permute(0, 3, 1, 2), layer.conv, torch.bfloat16)


def layout_of(t) -> str:
    import torch
    if t.is_contiguous():
        return "nchw"
    return "channels_last" if t.is_contiguous(memory_format=torch.channels_last) else "other"


def check_stem_norm(label: str, batch: int, img: int, train: bool, path: str, reps: int):
    """B1 (and in train mode B2) at a stem norm's shape, with the ReLU,
    against the float32 PyTorch ops the port ran before, with their own ReLU
    (:func:`check_relu_norm`); ``plain_ms`` is those ops under
    autograd, ``library_ms`` ``F.batch_norm`` (cuDNN) and ``F.relu``, which
    the port never calls. Bounds: three passes over the activation forward
    (two in eval mode), five backward."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import batch_norm as BN

    x = stem_activation(batch, img, 700 + img)
    c = x.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(701)
    g = torch.empty_like(x).normal_(generator=gen)
    w = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1.0
    bias = torch.randn(c, device="cuda", generator=gen) * 0.5
    stats = [torch.randn(c, device="cuda", generator=gen) * 0.1,
             torch.rand(c, device="cuda", generator=gen) + 0.5]
    shape = {"B": batch, "C": c, "H": x.shape[2], "W": x.shape[3], "dtype": "bfloat16",
             "layout": layout_of(x), "train": train}
    what = f"stem batch norm {label} (B, C, H, W) = {tuple(x.shape)} {shape['layout']}"

    def run(fn):
        rm, rv = (t.clone() for t in stats)
        leaf, lw, lb = (t.clone().requires_grad_(train) for t in (x, w, bias))
        with torch.set_grad_enabled(train):
            y = fn(leaf, lw, lb, rm, rv, train, 0.9, 1e-5, True)
            grads = torch.autograd.grad(y, (leaf, lw, lb), g) if train else ()
        return y.detach(), rm, rv, grads

    with torch.no_grad():
        z = BN.batch_norm_plain(x.float(), w, bias, *(t.clone() for t in stats), train, 0.9,
                                1e-5, False)
    errs = check_relu_norm(what, run(BN.batch_norm), run(BN.batch_norm_plain), z)
    del z

    rm, rv = (t.clone() for t in stats)
    if train:
        mean, var, n = BN.batch_stats_cuda(x, rm, rv, 0.9)

        def forward(x, rm, rv):
            m, v, _ = BN.batch_stats_cuda(x, rm, rv, 0.9)
            return BN.batch_norm_apply_cuda(x, m, v, w, bias, 1e-5, True)
    else:
        mean, var, n = rm, rv, 0

        def forward(x, rm, rv):
            return BN.batch_norm_apply_cuda(x, rm, rv, w, bias, 1e-5, True)
    fwd_ms = graph_ms(forward, (x, rm, rv), reps)
    leaf = x.clone().requires_grad_(train)
    with torch.no_grad():
        fwd_call_ms = time_ms(lambda: BN.batch_norm(leaf, w, bias, rm, rv, train, 0.9, 1e-5,
                                                    True), reps)
    px, pw, pb = (t.clone().requires_grad_(train) for t in (x, w, bias))
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: BN.batch_norm_plain(px, pw, pb, rm, rv, train, 0.9,
                                                           1e-5, True), reps)
    lw, lb = w.clone().requires_grad_(train), bias.clone().requires_grad_(train)

    def library():
        return F.relu(F.batch_norm(leaf, rm, rv, lw, lb, train, 0.1, 1e-5))

    with torch.no_grad():
        lib_fwd_ms = time_ms(library, reps)
    fwd_bytes = (3 if train else 2) * nbytes(x)
    bfwd = bound(fwd_bytes, 0.0, PEAK_F32)
    entries = [dict(name="batch_norm_apply", stage=label, shape=shape, path=path,
                    max_abs_err=errs["y"], errors=errs,
                    tolerance=(f"y, dx: abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref|; "
                               f"running statistics {STATS_TOL}; dw/db {F32_SUM_TOL}"),
                    ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms, bound_ms=bfwd[0],
                    bound_by=bfwd[1], library_ms=lib_fwd_ms,
                    library_call="F.relu(F.batch_norm(...)) forward (cuDNN)",
                    what=("B1 statistics and normalize" if train else "B1 normalize"))]
    line = (f"{what}: B1 {fwd_ms:.4f} ms (bound {bfwd[0]:.4f}, {fwd_call_ms:.4f} per call); "
            f"plain {plain_fwd_ms:.3f} ms; cuDNN {lib_fwd_ms:.4f} ms")
    if train:
        bwd_ms = graph_ms(BN.batch_norm_bwd_cuda,
                          (x, g, mean, var, w, bias, 1e-5, True, 1.0 / n), reps)
        bwd_call_ms = time_ms(lambda: torch.autograd.grad(
            BN.batch_norm(leaf, w, bias, rm, rv, True, 0.9, 1e-5, True), leaf, g),
            reps) - fwd_call_ms
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            BN.batch_norm_plain(px, pw, pb, rm, rv, True, 0.9, 1e-5, True), (px, pw, pb), g),
            reps) - plain_fwd_ms
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(library(), (leaf, lw, lb), g),
                             reps) - lib_fwd_ms
        bbwd = bound(5 * nbytes(x), 0.0, PEAK_F32)
        entries.append(dict(name="batch_norm_bwd", stage=label, shape=shape, path=path,
                            max_abs_err=errs["dx"], errors=errs, tolerance=entries[0]["tolerance"],
                            ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_bwd_ms,
                            bound_ms=bbwd[0], bound_by=bbwd[1], library_ms=lib_bwd_ms,
                            library_call="F.relu(F.batch_norm(...)) (forward+backward) - forward",
                            what="B2 sums and dx"))
        line += (f"; B2 {bwd_ms:.4f} ms (bound {bbwd[0]:.4f}, {bwd_call_ms:.4f} per call); "
                 f"plain {plain_bwd_ms:.3f} ms; cuDNN {lib_bwd_ms:.4f} ms")
    log(line + f"; errors {json.dumps(errs)}")
    return entries


def stem_module(batch: int = 1024, img: int = 224, reps: int = 5) -> dict:
    """The whole ``PatchConvEmbed`` of the ViT-ResNAS cells (24 channels,
    embed 240, bf16) through its module: a train forward and backward, then
    an eval forward; each norm's input and gradient layouts as they arrive,
    the launches of each record, the largest float32 tensor saved for the
    backward, and each pass's time."""
    import torch
    from vit_search_torch.models.patch_embed import ConvBnAct, PatchConvEmbed
    from vit_search_torch.ops import kernels

    stem = PatchConvEmbed(img, 14, 240, STEM_CHANNELS, torch.bfloat16,
                          torch.Generator().manual_seed(0)).cuda()
    images = torch.randn(batch, img, img, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    layouts = []

    def note(module, args, out):
        entry = {"y": layout_of(out)}
        layouts.append(entry)
        if out.requires_grad:
            out.register_hook(lambda grad: entry.update(dy=layout_of(grad)))

    hooks = [m.register_forward_hook(note) for m in stem.modules() if isinstance(m, ConvBnAct)]
    saved = []

    def pack(t):
        saved.append((str(t.dtype), t.numel()))
        return t

    kernels.reset_launches()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = stem(images)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    train_launches = {k.name: k.launches for k in kernels.KERNELS if k.name.startswith("batch_")}
    for h in hooks:
        h.remove()
    kernels.reset_launches()
    with torch.no_grad():
        stem.eval()(images)
    eval_launches = {k.name: k.launches for k in kernels.KERNELS if k.name.startswith("batch_")}
    want_train = with_stem({}, STEM_NORMS, True)
    want_eval = with_stem({}, STEM_NORMS, False)
    if train_launches != want_train or eval_launches != want_eval:
        raise AssertionError(f"stem: launches {train_launches} / {eval_launches}, expected "
                             f"{want_train} / {want_eval}")
    f32 = max([n for dtype, n in saved if dtype == "torch.float32"], default=0)
    activation = batch * STEM_CHANNELS * (img // 2) ** 2
    if f32 >= activation:
        raise AssertionError(f"stem: a float32 tensor of {f32} elements is saved for the "
                             f"backward (an activation holds {activation})")
    stem.train()
    grad = torch.ones_like(out)

    def step():
        stem(images).backward(grad)

    train_ms = time_ms(step, reps)
    with torch.no_grad():
        stem.eval()
        eval_ms = time_ms(lambda: stem(images), reps)
    return {"batch": batch, "img": img, "layouts": layouts, "train_launches": train_launches,
            "eval_launches": eval_launches, "largest_saved_float32": f32,
            "activation_elements": activation, "train_ms": train_ms, "eval_ms": eval_ms}


def stem_phase(reps: int) -> dict:
    """B1/B2 at each of ``STEM_CASES``, then the whole stem module."""
    entries = []
    for case in STEM_CASES:
        entries += check_stem_norm(*case, reps)
    module = stem_module()
    log(f"stem module (B {module['batch']}, {module['img']} px): forward+backward "
        f"{module['train_ms']:.3f} ms, eval forward {module['eval_ms']:.3f} ms; layouts "
        f"{json.dumps(module['layouts'])}; launches {json.dumps(module['train_launches'])} / "
        f"eval {json.dumps(module['eval_launches'])}; largest float32 saved "
        f"{module['largest_saved_float32']}")
    return {"entries": entries, "module": module}


def check_row_stats(stage: int, reps: int, batch: int, path: str):
    """K5 against its plain version at ``batch``."""
    import torch
    from vit_search_torch.ops import stats as S

    n, c, _, _ = STAGES[stage]
    gen = torch.Generator(device="cuda").manual_seed(200 + stage)
    x = (torch.randn(batch, n, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    s1, s2 = S.row_sum_sumsq_cuda(x)
    torch.cuda.synchronize()
    ref1, ref2 = S.row_sum_sumsq_plain(x)
    err = max(compare(f"K5 sum stage {stage + 1} B={batch}", s1, ref1, STATS_TOL),
              compare(f"K5 sumsq stage {stage + 1} B={batch}", s2, ref2, STATS_TOL))
    call_ms = time_ms(lambda: S.row_sum_sumsq_cuda(x), reps)
    ms = graph_ms(S.row_sum_sumsq_cuda, (x,), reps)
    plain_ms = time_ms(lambda: S.row_sum_sumsq_plain(x), reps)
    b = bound(nbytes(x, ref1, ref2), 3.0 * x.numel(), PEAK_F32)
    return [dict(name="row_sum_sumsq", stage=stage + 1, path=path,
                 shape={"B": batch, "N": n, "C": c, "dtype": "bfloat16"}, max_abs_err=err,
                 tolerance=f"abs <= {STATS_TOL[0]}*max|ref| + {STATS_TOL[1]}*|ref| (f32 sums)",
                 ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b[0],
                 bound_by=b[1], library_ms=None,
                 library_call="none: no single PyTorch call returns both sums")]


def lab_cases():
    """The lab's kernels: ``(name, wrapper, plain version, takes do, flops
    per B*H*N*N*D)``."""
    from vit_search_torch.tools import attn_lab as lab

    return (("lab_fwd_t", lab.fwd_T_cuda, lab.fwd_T_plain, False, 4.0),
            ("lab_bwd_t", lab.bwd_T_cuda, lab.bwd_T_plain, True, 10.0),
            ("lab_split_dq", lab.split_dq_cuda, lab.split_dq_plain, True, 6.0),
            ("lab_split_dkv", lab.split_dkv_cuda, lab.split_dkv_plain, True, 8.0))


def lab_base(name: str):
    """K1's or K2's plain function in the output layout of lab kernel
    ``name``, and the K1 or K2 wrapper with the same arguments (K2 only for
    K11, which computes all of its cotangent)."""
    from vit_search_torch.ops import attention as A

    if name == "lab_fwd_t":
        return A.attention_qkv_plain, A.attention_qkv_fwd_cuda
    lo, hi = {"lab_bwd_t": (0, 3), "lab_split_dq": (0, 1), "lab_split_dkv": (1, 3)}[name]

    def plain(qkv, do, scale, h):
        w = do.shape[-1]
        return A.attention_qkv_bwd_plain(qkv, do, scale, h)[..., lo * w:hi * w]

    return plain, A.attention_qkv_bwd_cuda if name == "lab_bwd_t" else None


def mean_abs_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().mean())


def check_lab(stage: int, reps: int):
    """The attention lab's kernels (K10, K11, K12a, K12b) against their plain
    versions at the train batch. Yardstick: SDPA's forward for K10, its
    backward (forward+backward less forward) for K11 and for the pair K12a +
    K12b, whose time as one call (``split_cuda``, the concatenation
    included) the K12 entries carry as ``pair_ms``."""
    import functools

    import torch
    import torch.nn.functional as F
    from vit_search_torch.tools import attn_lab as lab

    n, _, h, d = STAGES[stage]
    b, w, scale = BATCH, h * d, d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(400 + stage)
    qkv = torch.randn(b, n, 3 * w, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(b, n, w, device="cuda", generator=gen).to(torch.bfloat16)
    shape = {"B": b, "N": n, "H": h, "D": d, "dtype": "bfloat16", "layout": "packed"}
    tolerance = f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)"

    _, _, _, views, g_view = attention_layout("packed", qkv, do, h)
    leaves = (qkv.clone().requires_grad_(),)
    q, k, v = views(leaves)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    with torch.no_grad():
        sdpa_fwd_ms = time_ms(sdpa, reps)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, g_view), reps) - sdpa_fwd_ms
    pair_ms = graph_ms(lab.split_cuda, (qkv, do, scale, h), reps)
    entries = []
    for name, cuda_fn, plain, with_do, flops in lab_cases():
        args = (qkv, do, scale, h) if with_do else (qkv, scale, h)
        got = cuda_fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = compare(f"{name} stage {stage + 1} B={b}", got, want, BF16_TOL)
        # the distinction the lab shows: the error against K1's / K2's plain
        # function, and (K10, K11) the mean error against the f32 function
        # beside that of K1 / K2 on the card, which must be larger
        base_plain, base_cuda = lab_base(name)
        closer = {}
        if base_cuda is not None:
            f32_args = tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)
            f32 = plain(*f32_args)
            closer = dict(f32_mean_err=mean_abs_err(got, f32),
                          base_f32_mean_err=mean_abs_err(base_cuda(*args), f32))
            if not closer["f32_mean_err"] < closer["base_f32_mean_err"]:
                raise AssertionError(f"{name} stage {stage + 1}: mean error against the f32 "
                                     f"function {closer['f32_mean_err']:.3e} not below K1/K2's "
                                     f"{closer['base_f32_mean_err']:.3e}")
            del f32
        err_vs_base = float((got.float() - base_plain(*args).float()).abs().max())
        del got
        log(f"{name} stage {stage + 1}: max abs err {err:.3e} against its plain version, "
            f"{err_vs_base:.3e} against K1/K2's"
            + ("".join(f", {k} {v:.3e}" for k, v in closer.items())))
        bnd = bound(nbytes(*args[:-2], want), flops * b * h * n * n * d, PEAK_BF16)
        e = dict(name=name, stage=stage + 1, shape=shape, path="lab", max_abs_err=err,
                 err_vs_base=err_vs_base, **closer,
                 tolerance=tolerance, ms=graph_ms(cuda_fn, args, reps),
                 call_ms=time_ms(functools.partial(cuda_fn, *args), reps),
                 plain_ms=time_ms(functools.partial(plain, *args), reps), bound_ms=bnd[0],
                 bound_by=bnd[1])
        if name == "lab_fwd_t":
            e.update(library_ms=sdpa_fwd_ms, library_call="F.scaled_dot_product_attention forward")
        else:
            e.update(library_ms=sdpa_bwd_ms,
                     library_call="F.scaled_dot_product_attention (forward+backward) - forward")
        if name.startswith("lab_split"):
            e.update(pair_ms=pair_ms, library_call=e["library_call"] + ": dq, dk and dv, the "
                     "pair K12a + K12b's function (compare with pair_ms)")
        entries.append(e)
    return entries


def check_extra_shapes(reps: int):
    """The attention kernels past the supernet's shapes, with the launches of
    the ``shapes`` path: the 392 px finetune's stage 1 (the bf16 backward on
    the split route), K1/K2 in both dtypes and K6-K9 in bf16, and K1/K2 at
    a head dim of 24."""
    label, b, n, h, d = FINETUNE_392[0]
    entries = []
    for dtype, layout in (("bfloat16", "packed"), ("float32", "packed"),
                          ("bfloat16", "separate"), ("bfloat16", "seq_major")):
        entries += check_attention(label, reps, b, "shapes", backward=True, layout=layout,
                                   nhd=(n, h, d), dtype=dtype)
    label, b, n, h, d = HEAD_DIM_24
    return entries + check_attention(label, reps, b, "shapes", backward=True, nhd=(n, h, d))


def check_dense_shapes(reps: int):
    """K1/K2 at the shapes the searched, finetune and distill paths give
    them: the searched Tiny net's stages at their widest heads (B 512), the
    392 px finetune's three stages (B 64; stage 1 on the split route) and
    DeiT-S's (B 512, N 198, 6 heads of 64), bf16."""
    entries = []
    for path, shapes in (("searched", SEARCHED_SHAPES), ("finetune", FINETUNE_392),
                         ("distill", DISTILL_SHAPES)):
        for label, b, n, h, d in shapes:
            entries += check_attention(label, reps, b, path, backward=True, nhd=(n, h, d))
    return entries


def check_kernels(stage: int, reps: int):
    """Every kernel at the shapes each main path gives it: the train step's
    batch (K1-K4; K5 at the same batch, the training step on the stats
    route; K6-K9, the op-level API's), and a scoring forward's ``ARCH_BATCH * VAL_BATCH`` images (K1 and K5 on
    the stats-route search, K1 and K3 on the fused-route one)."""
    return (check_attention(stage, reps, BATCH, "train", backward=True)
            + check_attention(stage, reps, BATCH, "ops", backward=True, layout="separate")
            + check_attention(stage, reps, BATCH, "ops", backward=True, layout="seq_major")
            + check_lab(stage, reps)
            + check_masked_ln(stage, reps, BATCH, "train", backward=True)
            + check_row_stats(stage, reps, BATCH, "search")
            + check_attention(stage, reps, SEARCH_BATCH, "search", backward=False)
            + check_masked_ln(stage, reps, SEARCH_BATCH, "search_fused", backward=False)
            + check_row_stats(stage, reps, SEARCH_BATCH, "search"))


def check_reference_net(ln_route: str, dtype=None, dense: bool = False,
                        distill: bool = False):
    """A small conv-stem supernet, float32 (or ``dtype``): card (kernels) vs
    CPU (plain). In bfloat16 the loss, gradient norm and logits are held to
    ``REF_NET_BF16_TOL``; AdamW's first step moves each parameter by about lr
    whatever its gradient, so only the float32 run holds the parameters.
    ``dense`` trains the same net as a searched net (no masks, so K3/K4's
    dense mode on the card) with random erasing, gradient clipping and the
    EMA on, the erasing boxes and noise drawn once on the host for both
    devices; the EMA (decay
    ``EMA_DECAY``, which damps the step's difference) is held to the
    parameters' float32 tolerance in both dtypes. ``distill`` gives the net
    a distill token and trains it with timm Mixup/CutMix (``elem`` mode),
    dropout ``REF_DROPOUT`` and hard distillation from a narrow RegNetY
    teacher (``REF_TEACHER``: the 112 px batch resized to 96 px), the mixup
    draws and dropout keeps made once on the host; the teacher runs in
    float32 in both dtypes (in bf16 its hard labels flip on near-ties, which
    the loss cannot absorb), its logits held card vs CPU within 1e-4 in
    float32 and, on the same input in bfloat16, within the bf16 logits
    tolerance."""
    import numpy as np
    import torch
    from vit_search_torch.data import sample_erasing_draws, sample_mixup_draws
    from vit_search_torch.data.mixup import sample_token_mix_draws
    from vit_search_torch.models import (RegNetYUpsample, SupernetSchedules, build_arch_masks,
                                         create_model)
    from vit_search_torch.train import (OptimConfig, StepDraws, TrainConfig, lr_schedule,
                                        make_optimizer, make_teacher, make_train_step)

    dtype = dtype or torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = ((4, 64),
           (1, (64, 4, 16), (64, 128), 1), (1, (64, 4, 16), (64, 128), 1),
           (3, 64, 128),
           (1, (128, 4, 32), (128, 256), 1),
           (3, 128, 256),
           (1, (256, 4, 64), (256, 512), 1),
           (2, 256, 10))
    space = [np.array([64, 48]),
             {"attn": np.array([64, 32]), "mlp": np.array([128, 96]), "layer": None},
             {"attn": np.array([64, 32]), "mlp": np.array([128, 96]),
              "layer": np.array([64, 0])},
             np.array([128, 96]),
             {"attn": np.array([128, 64]), "mlp": np.array([256, 192]), "layer": None},
             np.array([256, 192]),
             {"attn": np.array([256, 128]), "mlp": np.array([512, 256]), "layer": None},
             None]
    batch, img, clip = 8, 112, 1e-2
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (batch, img, img, 3), dtype=np.uint8))
    labels = torch.as_tensor(rng.integers(0, 10, batch))
    sched = SupernetSchedules(net, space, example_per_arch=2, num_warmup_epochs=0)
    counts = None if dense else sched.sample_packed(rng, batch)
    draws = StepDraws(mix=sample_token_mix_draws(rng, batch, 2),
                      drop_keeps=[torch.as_tensor(rng.random(batch) < 0.9) for _ in range(8)])
    cfg = TrainConfig(num_classes=10, mixup_mode="token", patch_len=2)
    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=1, global_batch_size=batch)
    name = "flexible_vit_sr_patch14_224_patch_output_supernet"
    extra = {}
    if dense:
        name = SEARCHED_MODEL
        cfg = TrainConfig(num_classes=10, mixup_mode="token", patch_len=2, ema_decay=EMA_DECAY,
                          erasing_prob=0.5, erasing_mode="pixel", erasing_count=2)
        ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=1, global_batch_size=batch,
                           clip_grad=clip)
        draws.erasing = sample_erasing_draws(rng, batch, img, img, 0.5, 2)
        draws.erasing.fill = torch.randn(2, batch, img, img, 3,
                                         generator=torch.Generator().manual_seed(2))
    if distill:
        name = "flexible_vit_sr_distill_patch14_224_supernet"
        extra = {"dropout_rate": REF_DROPOUT}
        cfg = TrainConfig(num_classes=10, mixup_mode="mixup", mixup_elem_mode="elem",
                          distill_alpha=0.5, hard_distill=True)
        draws.mix, draws.mixup = None, sample_mixup_draws(rng, batch, img, img, mode="elem")
    results = {}
    for dev in ("cpu", "cuda"):
        model = create_model(name, network_def=net, img_size=img, drop_path_rate=0.1,
                             gelu="tanh", device=dev, seed=0, ln_route=ln_route, dtype=dtype,
                             **extra)
        if distill and draws.dropout_keeps is None:
            draws.dropout_keeps = [torch.as_tensor(rng.random(shape) >= REF_DROPOUT)
                                   for shape in model.dropout_shapes(batch)]
        masks = None if dense else build_arch_masks(sched.unpack(counts, batch), net, batch,
                                                    device=dev)
        x = torch.randn(batch, img, img, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        dev_draws = StepDraws(mix=draws.mix, drop_keeps=[k.to(dev) for k in draws.drop_keeps],
                              erasing=draws.erasing, mixup=draws.mixup,
                              dropout_keeps=None if draws.dropout_keeps is None else
                              [k.to(dev) for k in draws.dropout_keeps])
        heads = model(x, masks, patch_output_type="seq", drop_keeps=dev_draws.drop_keeps,
                      dropout_keeps=dev_draws.dropout_keeps)
        teacher, teacher_logits = None, {}
        if distill:
            teacher_model = RegNetYUpsample(**REF_TEACHER, device=dev, seed=3)
            teacher = make_teacher(teacher_model)
            teacher_logits["float32"] = teacher(x).cpu()
            teacher_bf16 = RegNetYUpsample(**REF_TEACHER, device=dev, seed=3,
                                           dtype=torch.bfloat16)
            teacher_logits["bfloat16"] = make_teacher(teacher_bf16)(x).float().cpu()
        step = make_train_step(model, make_optimizer(ocfg, model), cfg,
                               schedule=lr_schedule(ocfg),
                               counts_unpack=None if dense else sched.unpack, device=dev,
                               teacher=teacher)
        metrics = step(images.to(dev), labels.to(dev), counts, draws=dev_draws)
        ema = {k: v.detach().cpu() for k, v in (step.state.ema_params or {}).items()}
        results[dev] = ([h.detach().cpu() for h in heads], float(metrics["loss"]),
                        float(metrics["grad_norm"]),
                        {k: v.detach().cpu() for k, v in model.state_dict().items()}, ema,
                        teacher_logits)
    (h0, l0, g0, sd0, ema0, t0), (h1, l1, g1, sd1, ema1, t1) = results["cpu"], results["cuda"]
    bf16 = dtype == torch.bfloat16
    tol = REF_NET_BF16_TOL if bf16 else {"logits": (1e-3, 1e-3), "loss": 1e-4,
                                         "grad_norm": 1e-4}
    second = "dst_logits" if distill else "patch_logits"
    errs = {"cls_logits": compare("ref net cls logits", h1[0], h0[0], tol["logits"]),
            second: compare(f"ref net {second}", h1[1], h0[1], tol["logits"])}
    for what, a, b_ in (("loss", l1, l0), ("grad_norm", g1, g0)):
        if not math.isclose(a, b_, rel_tol=tol[what]):
            raise AssertionError(f"ref net {what}: card {a} vs CPU {b_}")
        errs[what] = abs(a - b_)
    if dense:
        if not (g0 > clip and g1 > clip):
            raise AssertionError(f"ref net: gradient norms {g0}, {g1} not clipped at {clip}")
        if not draws.erasing.apply.any():
            raise AssertionError("ref net: no image erased")
        errs["ema_params"] = max(compare(f"ref net EMA {k}", ema1[k], ema0[k], (1e-4, 1e-4),
                                         floor=1e-6) for k in ema0)
    if distill:
        errs["teacher_logits_f32"] = compare("ref net teacher logits", t1["float32"],
                                             t0["float32"], (1e-4, 1e-4))
        errs["teacher_logits_bf16"] = compare("ref net teacher logits, bf16", t1["bfloat16"],
                                              t0["bfloat16"], REF_NET_BF16_TOL["logits"])
        if not np.asarray(draws.mixup.use_cutmix).any() or np.asarray(
                draws.mixup.use_cutmix).all():
            raise AssertionError("ref net: the mixup draws took one branch only")
    if bf16:
        return errs
    # AdamW's first step moves each parameter by about lr whatever the
    # gradient's size, so parameters are held to an absolute floor
    errs["params_after_step"] = max(compare(f"ref net {k}", sd1[k], sd0[k], (1e-4, 1e-4),
                                            floor=1e-6) for k in sd0)
    return errs


def ops_path():
    """The op-level API as a caller uses it, at every stage shape at the train
    batch, forward and backward through autograd: ``fused_attention_packed``
    on separate ``(B, N, W)`` q, k, v, ``fused_attention`` on the same values
    as ``(B, N, H, D)`` tensors (its output and gradients must equal the
    first call's: both run K6/K7), and ``fused_attention_qkv_t`` on an ``(N,
    B, 3W)`` projection. The kernels' agreement with their plain versions is
    held in ``check_attention``. Returns the launches of this window."""
    import torch
    from vit_search_torch.ops import attention as A
    from vit_search_torch.ops import kernels

    kernels.reset_launches()
    for stage, (n, _, h, d) in enumerate(STAGES):
        gen = torch.Generator(device="cuda").manual_seed(300 + stage)
        w, scale = h * d, d ** -0.5
        q, k, v, g = (torch.randn(BATCH, n, w, device="cuda", generator=gen).to(torch.bfloat16)
                      for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = A.fused_attention_packed(*leaves, scale, h)
        grads = torch.autograd.grad(out, leaves, g)
        bnhd = [t.view(BATCH, n, h, d).clone().requires_grad_() for t in (q, k, v)]
        out4 = A.fused_attention(*bnhd, scale)
        grads4 = torch.autograd.grad(out4, bnhd, g.view(BATCH, n, h, d))
        if out4.shape != (BATCH, n, h, d) or not torch.equal(out4.view(out.shape), out):
            raise AssertionError(f"fused_attention stage {stage + 1}: not the output of "
                                 f"fused_attention_packed on the same values")
        if not all(torch.equal(a.view(b.shape), b) for a, b in zip(grads4, grads)):
            raise AssertionError(f"fused_attention stage {stage + 1}: gradients differ")
        qkv_t = torch.randn(n, BATCH, 3 * w, device="cuda", generator=gen).to(
            torch.bfloat16).requires_grad_()
        out_t = A.fused_attention_qkv_t(qkv_t, scale, h)
        (grad_t,) = torch.autograd.grad(out_t, qkv_t, g.transpose(0, 1))
        if out_t.shape != (n, BATCH, w) or grad_t.shape != qkv_t.shape:
            raise AssertionError(f"fused_attention_qkv_t stage {stage + 1}: shapes "
                                 f"{tuple(out_t.shape)}, {tuple(grad_t.shape)}")
        if not (torch.isfinite(out_t).all() and torch.isfinite(grad_t).all()):
            raise AssertionError(f"fused_attention_qkv_t stage {stage + 1}: non-finite")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check_launches(launches, PER_OPS_PASS, len(STAGES), "passes of the op-level API")
    return {"passes": len(STAGES), "batch": BATCH, "launches": launches}


def shapes_path():
    """The attention entry points forward and backward through autograd at
    the extra shapes (``EXTRA_CALLS``), as a caller of the op would run the
    392 px finetune or a net with head dim 24: outputs and gradients finite
    and of the expected shapes, one launch of the layout's forward and
    backward kernel per call (the bf16 backward at N = 785 launches the
    split route's two kernels as one call of K2, K7 or K9). The plain
    comparisons are ``check_extra_shapes``'s. Returns the launches of this
    window."""
    import torch

    from vit_search_torch.ops import kernels

    kernels.reset_launches()
    want = per_pass()
    for (label, b, n, h, d), dtype, layout in EXTRA_CALLS:
        gen = torch.Generator(device="cuda").manual_seed(500 + n + d)
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(getattr(torch, dtype))
        do = torch.randn(b, n, h * d, device="cuda", generator=gen).to(qkv.dtype)
        ins, g, ops, _, _ = attention_layout(layout, qkv, do, h)
        leaves = tuple(t.clone().requires_grad_() for t in ins)
        out = ops[0](*leaves, d ** -0.5, h)
        grads = torch.autograd.grad(out, leaves, g)
        what = f"{label} {dtype} {layout}"
        if out.shape != g.shape or any(a.shape != x.shape for a, x in zip(grads, leaves)):
            raise AssertionError(f"{what}: shapes {tuple(out.shape)}, "
                                 f"{[tuple(a.shape) for a in grads]}")
        if not all(torch.isfinite(t).all() for t in (out, *grads)):
            raise AssertionError(f"{what}: non-finite")
        for name in ATTENTION_KERNELS[layout]:
            want[name] += 1
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check_launches(launches, want, 1, "calls at the extra shapes")
    return {"calls": [[list(shape), dtype, layout] for shape, dtype, layout in EXTRA_CALLS],
            "launches": launches}


def lab_path():
    """The attention lab as its user runs it, at its full-width shapes:
    ``main()`` and ``main_split()``, their lines on stderr. Every kernel of
    the run launches exactly as often as the run calls it, and the lab's own
    errors (the transposed and split kernels against K1/K2) are within the
    bf16 tolerance of the base output's largest value. Then, outside the
    counted window, the lab's kernels against their plain versions at the
    lab's shapes, on the inputs ``main()`` drew."""
    import contextlib

    import torch
    from vit_search_torch.ops import kernels
    from vit_search_torch.tools import attn_lab as lab

    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        records = lab.main(iters=LAB_ITERS)
        split = lab.main_split(iters=LAB_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check_launches(launches, PER_LAB_SHAPE, len(lab.SHAPES), "shapes of the lab")
    atol = BF16_TOL[0]
    for r, rs in zip(records, split):
        for what, err, ref in (("bwd_err", r["bwd_err"], r["bwd_ref_max"]),
                               ("fwd_err", r["fwd_err"], r["fwd_ref_max"]),
                               ("split err", rs["err"], rs["ref_max"])):
            if not err <= atol * ref:
                raise AssertionError(f"lab {r['name']} {what} {err:.3e} above "
                                     f"{atol} * max|base| = {atol * ref:.3e}")
    # the plain versions' products in full f32, as in the kernel phase (the
    # train and search phases turn TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = False
    plain_errs = {}
    for name, b, n, h, d in lab.SHAPES:
        qkv, do = lab.inputs(torch.device("cuda"), b, n, h, d)
        for kname, cuda_fn, plain, with_do, _ in lab_cases():
            args = (qkv, do, d ** -0.5, h) if with_do else (qkv, d ** -0.5, h)
            plain_errs[f"{kname} {name}"] = compare(f"{kname} lab {name}", cuda_fn(*args),
                                                    plain(*args), BF16_TOL)
    return {"shapes": [list(s) for s in lab.SHAPES], "iters": LAB_ITERS, "seconds": seconds,
            "main": records, "main_split": split, "plain_max_abs_err": plain_errs,
            "launches": launches}


def check_launches(launches: dict, per: dict, passes: int, what: str) -> None:
    """Every kernel launched exactly ``per[name]`` times per pass."""
    for name, count in per.items():
        if launches[name] != count * passes:
            raise AssertionError(f"{name}: {launches[name]} launches in {passes} {what}, "
                                 f"expected {count} per pass")


def synthetic_batch(batch: int, img: int, seed: int):
    """Random uint8 NHWC images and labels on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (batch, img, img, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    return images, torch.randint(0, 1000, (batch,), device="cuda", generator=gen)


def run_steps(what: str, step, images, labels, counts, steps: int, warmup: int,
              per_step: dict, top: int = 12):
    """``warmup`` untimed steps, then ``steps`` timed ones (the launches of
    this window counted, exactly ``per_step`` each), then one more step
    under the profiler. ``counts()`` gives each step's keep counts."""
    import torch
    from vit_search_torch.ops import kernels

    batch = images.shape[0]
    t0 = time.perf_counter()
    warm = [step(images, labels, counts()) for _ in range(warmup)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = [step(images, labels, counts()) for _ in range(steps)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    losses = [float(m["loss"]) for m in warm + metrics]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    check_launches(launches, per_step, steps, f"{what} steps")
    # one more step under the profiler, outside the counted window
    busy_ms, wall_ms, classes, rows = profile_kernels(
        lambda: step(images, labels, counts()), top=top)
    by_class = ", ".join(f"{c} {ms:.1f}" for c, ms in sorted(classes.items(),
                                                            key=lambda kv: -kv[1]))
    log(f"{what}: profiled step {busy_ms:.1f} ms device-busy of "
        f"{wall_ms:.1f} ms ({by_class})")
    return {"steps": steps, "warmup_steps": warmup, "batch": batch,
            "imgs_per_s": batch * steps / elapsed, "step_ms": 1e3 * elapsed / steps,
            "warmup_s": warm_s, "max_memory_allocated_bytes": peak,
            "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in warm + metrics],
            "launches": launches,
            "profiled_step": {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
                              "by_class_ms": classes, "top_kernels": rows}}


def supernet_step(network_def=None, space: str = "sr_tiny_mh", batch: int = BATCH,
                  example_per_arch: int = EXAMPLE_PER_ARCH, drop_path: float = 0.2,
                  gelu: str = "tanh", patch_len: int = 4):
    """The train phase's step: the full-width ``SUPERNET_SR_TINY_MH``
    supernet, token mixup, drop_path 0.2, tanh GELU, bf16, AdamW; and its
    keep-count sampler. A supernet recipe passes its script's values."""
    import gc

    import torch
    from vit_search_torch.arch import presets, spaces
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule,
                                        make_optimizer, make_train_step)

    gc.collect()   # the last phase's model and optimizer off the card
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    net = network_def or presets.SUPERNET_SR_TINY_MH
    model = create_model("flexible_vit_sr_patch14_224_patch_output_supernet",
                         network_def=net, dtype=torch.bfloat16, drop_path_rate=drop_path,
                         gelu=gelu, seed=0)
    ocfg = OptimConfig(base_lr=5e-4, warmup_epochs=5, epochs=120, steps_per_epoch=1000,
                       global_batch_size=batch)
    sched = SupernetSchedules(net, spaces.get_space(space), example_per_arch=example_per_arch,
                              num_warmup_epochs=0, arch_mode="multi")
    step = make_train_step(model, make_optimizer(ocfg, model),
                           TrainConfig(num_classes=1000, mixup_mode="token", patch_len=patch_len),
                           schedule=lr_schedule(ocfg), counts_unpack=sched.unpack, seed=0)
    return step, sched


def train(steps: int, warmup: int):
    import numpy as np

    step, sched = supernet_step()
    images, labels = synthetic_batch(BATCH, 224, 0)
    rng = np.random.default_rng(0)
    return run_steps("train", step, images, labels, lambda: sched.sample_packed(rng, BATCH),
                     steps, warmup, PER_STEP)


def check_ema(what: str, step) -> None:
    """The step's EMA is finite and not the parameters."""
    import torch

    ema, params = step.state.ema_params, dict(step.model.named_parameters())
    if not all(torch.isfinite(t).all() for t in ema.values()):
        raise AssertionError(f"{what}: non-finite EMA")
    if all(torch.equal(t, params[k]) for k, t in ema.items()):
        raise AssertionError(f"{what}: the EMA equals the parameters")


def searched(steps: int, warmup: int):
    """searched_net/tiny.sh: the dense ViT-ResNAS-Tiny at 224 px, batch
    ``BATCH``, token mixup (patch_len 4), drop_path 0.2, random erasing,
    EMA, AdamW, tanh GELU, bf16."""
    import gc

    import torch
    from vit_search_torch.arch import network_def as nd
    from vit_search_torch.arch import presets
    from vit_search_torch.models import create_model
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule,
                                        make_optimizer, make_train_step)

    gc.collect()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    net = presets.VIT_RESNAS_TINY
    if nd.existing_depth(net) != PER_SEARCHED_STEP["attention_qkv_fwd"]:
        raise AssertionError("PER_SEARCHED_STEP does not count the net's attention layers")
    if dense_lns(net) != PER_SEARCHED_STEP["layer_norm_fwd"]:
        raise AssertionError("PER_SEARCHED_STEP does not count the net's layer norms")
    if stem_norms(net) != PER_SEARCHED_STEP["batch_norm_apply"]:
        raise AssertionError("PER_SEARCHED_STEP does not count the net's batch norms")
    model = create_model(SEARCHED_MODEL, network_def=net, dtype=torch.bfloat16,
                         drop_path_rate=0.2, gelu="tanh", seed=0)
    ocfg = OptimConfig(base_lr=5e-4, warmup_epochs=5, epochs=300, steps_per_epoch=1000,
                       global_batch_size=BATCH)
    cfg = TrainConfig(num_classes=1000, mixup_mode="token", patch_len=4,
                      ema_decay=EMA_DECAY, **ERASING)
    step = make_train_step(model, make_optimizer(ocfg, model), cfg,
                           schedule=lr_schedule(ocfg), seed=0)
    images, labels = synthetic_batch(BATCH, 224, 0)
    out = run_steps("searched", step, images, labels, lambda: None, steps, warmup,
                    PER_SEARCHED_STEP)
    check_ema("searched", step)
    return out


def finetune(steps: int, warmup: int):
    """finetune/medium_img-size@392.sh: ViT-ResNAS-Medium trains two steps
    at 224 px with the EMA, is saved through ``CheckpointManager`` and read
    back by ``restore_raw``; ``load_finetune`` resizes its EMA's position
    tables on the card into the 392 px net (held to the same surgery on the
    CPU within 1e-5, the cls rows bit for bit), which then trains at batch
    ``FINETUNE_BATCH``: patch_len 7, drop_path 0.75, lr 5e-6, weight decay
    1e-8, random erasing and the EMA on. The profiled step's backward
    launches by name show K2's route at each stage: at 392 px stage 1 (N =
    785, D = 32) the split route, two launches per call."""
    import gc
    import tempfile

    import torch
    from vit_search_torch.arch import network_def as nd
    from vit_search_torch.arch import presets
    from vit_search_torch.models import create_model, interpolate_pos_embeds
    from vit_search_torch.ops import attention as A
    from vit_search_torch.train import (CheckpointManager, OptimConfig, TrainConfig,
                                        load_finetune, lr_schedule, make_optimizer,
                                        make_train_step, restore_raw)

    gc.collect()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    net = presets.VIT_RESNAS_MEDIUM
    if nd.existing_depth(net) != PER_FINETUNE_STEP["attention_qkv_fwd"]:
        raise AssertionError("PER_FINETUNE_STEP does not count the net's attention layers")
    if dense_lns(net) != PER_FINETUNE_STEP["layer_norm_fwd"]:
        raise AssertionError("PER_FINETUNE_STEP does not count the net's layer norms")
    if stem_norms(net) != PER_FINETUNE_STEP["batch_norm_apply"]:
        raise AssertionError("PER_FINETUNE_STEP does not count the net's batch norms")

    # the searched Medium net: two steps at 224 px, then its checkpoint
    src = create_model(SEARCHED_MODEL, network_def=net, dtype=torch.bfloat16,
                       drop_path_rate=0.3, gelu="tanh", seed=0)
    ocfg = OptimConfig(base_lr=5e-4, warmup_epochs=0, epochs=300,
                       global_batch_size=FINETUNE_BATCH)
    src_step = make_train_step(src, make_optimizer(ocfg, src),
                               TrainConfig(num_classes=1000, mixup_mode="token", patch_len=4,
                                           ema_decay=EMA_DECAY, **ERASING),
                               schedule=lr_schedule(ocfg), seed=0)
    images, labels = synthetic_batch(FINETUNE_BATCH, 224, 2)
    src_losses = [float(src_step(images, labels)["loss"]) for _ in range(2)]
    if not all(math.isfinite(v) for v in src_losses):
        raise AssertionError(f"finetune source: non-finite loss {src_losses}")
    check_ema("finetune source", src_step)
    del images, labels

    with tempfile.TemporaryDirectory() as tmp:
        CheckpointManager(tmp).save("best_ema", src_step, {"epoch": 0})
        path = os.path.join(tmp, "best_ema")
        raw = restore_raw(path)
        del src_step, src
        gc.collect()
        model = create_model(FINETUNE_MODEL, network_def=net, dtype=torch.bfloat16,
                             drop_path_rate=0.75, gelu="tanh", seed=1)
        load_finetune(model, path)
    card = dict(model.named_parameters())
    want = interpolate_pos_embeds(raw["ema_params"], {k: v.detach().cpu()
                                                      for k, v in card.items()},
                                  model.num_tokens)
    tables = {}
    for k, v in want.items():
        got = card[k].detach().cpu()
        if k.endswith("pos_embed"):
            tables[k] = [list(raw["ema_params"][k].shape), list(v.shape),
                         float((got - v).abs().max())]
            if tables[k][2] > 1e-5:
                raise AssertionError(f"finetune {k}: card and CPU surgery differ by "
                                     f"{tables[k][2]:.3e}")
        elif not torch.equal(got, v):
            raise AssertionError(f"finetune {k}: not the checkpoint's EMA")
    if not torch.equal(card["pos_embed"][:, :1].detach().cpu(),
                       raw["ema_params"]["pos_embed"][:, :1]):
        raise AssertionError("finetune: the cls row of pos_embed moved")
    del raw, want

    ft_ocfg = OptimConfig(base_lr=5e-6, min_lr=5e-6, weight_decay=1e-8, warmup_epochs=5,
                          epochs=30, steps_per_epoch=1000, global_batch_size=512)
    cfg = TrainConfig(num_classes=1000, mixup_mode="token", patch_len=7,
                      ema_decay=EMA_DECAY, **ERASING)
    step = make_train_step(model, make_optimizer(ft_ocfg, model), cfg,
                           schedule=lr_schedule(ft_ocfg), seed=0)
    images, labels = synthetic_batch(FINETUNE_BATCH, 392, 3)
    out = run_steps("finetune", step, images, labels, lambda: None, steps, warmup,
                    PER_FINETUNE_STEP, top=1000)
    check_ema("finetune", step)

    # K2's route at each stage, from the net and from the profiled step's
    # launches by kernel name
    stages = [{k: st[k] for k in ("N", "D", "blocks")} for st in net_stages(net, 392)]
    for st in stages:
        st["route"] = "split" if A.backward_is_split(st["N"], st["D"]) else "one launch"
    calls = {name: sum(c for key, _, c in out["profiled_step"]["top_kernels"] if name in key)
             for name in ("attn_split_dq_kernel", "attn_split_dkv_kernel", "attn_bwd_kernel")}
    split_blocks = sum(st["blocks"] for st in stages if st["route"] == "split")
    if stages[0]["route"] != "split" or not (
            calls["attn_split_dq_kernel"] == calls["attn_split_dkv_kernel"] == split_blocks
            and calls["attn_bwd_kernel"] + split_blocks == sum(st["blocks"] for st in stages)):
        raise AssertionError(f"finetune: K2's routes {stages} and its launches {calls} "
                             f"disagree, or stage 1 is not on the split route")
    out["profiled_step"]["top_kernels"] = out["profiled_step"]["top_kernels"][:12]
    out.update(k2_routes=stages, k2_launches_by_name=calls, pos_embed_tables=tables,
               source_losses=src_losses)
    return out


def script_command(path: str, env=None):
    """``(cli, argv)`` of a published script: the CLI it runs (``train`` or
    ``evo_search``) and its arguments from the one after ``-m
    vit_search_tpu.cli.<cli>`` on, each shell variable that the script sets as
    ``VAR="${VAR:-default}"`` taken from ``env`` where given, else its
    default."""
    import re
    import shlex

    with open(os.path.join(HERE, path)) as f:
        text = f.read()
    values = dict(re.findall(r'^(\w+)="\$\{\1:-([^}]*)\}"', text, re.M))
    values.update({k: v for k, v in (env or {}).items() if k in values})
    words = shlex.split(re.sub(r"\\\n", " ", text), comments=True)
    module = next(w for w in words if w.startswith("vit_search_tpu.cli."))
    argv = [re.sub(r"\$\{?(\w+)\}?", lambda m: values[m.group(1)], w)
            for w in words[words.index(module) + 1:]]
    return module.rsplit(".", 1)[1], argv


def script_network_def(path: str):
    """The ``--network-def`` literal of a training script, parsed by the
    port's ``parse_network_def``."""
    from vit_search_torch.arch import parse_network_def

    _, args = script_command(path)
    return parse_network_def(args[args.index("--network-def") + 1])


def mixup(steps: int, warmup: int):
    """super_net/no_distill/tiny_mh.sh: the supernet of the script's own
    network_def (linear stem, sr_tiny_mh widths), space ``sr_tiny_mh``,
    batch ``BATCH``, 32 examples per architecture, timm Mixup/CutMix in
    batch mode, smoothing 0.1, drop_path 0.2, tanh GELU, bf16, AdamW, no
    EMA; the same kernel launches per step as the train step."""
    import gc

    import numpy as np
    import torch
    from vit_search_torch.arch import network_def as nd
    from vit_search_torch.arch import spaces
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule,
                                        make_optimizer, make_train_step)

    gc.collect()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    net = script_network_def(MIXUP_SCRIPT)
    if nd.block_type(net[0]) != nd.LINEAR_EMBED or nd.existing_depth(net) != ATTENTION:
        raise AssertionError(f"{MIXUP_SCRIPT}: not the linear-stem 18-block supernet")
    model = create_model(MIXUP_MODEL, network_def=net, dtype=torch.bfloat16, drop_path_rate=0.2,
                         gelu="tanh", seed=0)
    ocfg = OptimConfig(base_lr=5e-4, warmup_epochs=5, epochs=120, steps_per_epoch=1000,
                       global_batch_size=BATCH)
    sched = SupernetSchedules(net, spaces.get_space("sr_tiny_mh"),
                              example_per_arch=EXAMPLE_PER_ARCH, num_warmup_epochs=0,
                              arch_mode="multi")
    step = make_train_step(model, make_optimizer(ocfg, model),
                           TrainConfig(num_classes=1000, smoothing=0.1, **MIXUP),
                           schedule=lr_schedule(ocfg), counts_unpack=sched.unpack, seed=0)
    images, labels = synthetic_batch(BATCH, 224, 4)
    rng = np.random.default_rng(0)
    out = run_steps("mixup", step, images, labels, lambda: sched.sample_packed(rng, BATCH),
                    steps, warmup, PER_MIXUP_STEP)
    out["network_def"] = repr(net)
    return out


def distill(steps: int, warmup: int):
    """The DeiT-S distillation recipe: ``deit_small_distill_patch16_224``
    (bf16, exact GELU, drop_path 0.1) at batch ``BATCH``, hard distillation
    (alpha 0.5) from ``regnety_160_upsample`` (random weights from seed 0,
    bf16, eval mode), Mixup/CutMix in batch mode, smoothing 0.1, EMA
    0.99996, AdamW. K1/K2 12 launches per step, K3/K4's dense mode 25, the
    masked K3/K4 and K5 none. The teacher's forward is bracketed by CUDA
    events in every step; the timed steps' mean is its time per step."""
    import gc

    import torch
    from vit_search_torch.arch import network_def as nd
    from vit_search_torch.models import BatchNorm, create_model
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule,
                                        make_optimizer, make_teacher, make_train_step,
                                        normalize)

    gc.collect()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    model = create_model(DISTILL_MODEL, dtype=torch.bfloat16, drop_path_rate=0.1, seed=0)
    if nd.existing_depth(model.network_def) != PER_DISTILL_STEP["attention_qkv_fwd"]:
        raise AssertionError("PER_DISTILL_STEP does not count the net's attention layers")
    if dense_lns(model.network_def) != PER_DISTILL_STEP["layer_norm_fwd"]:
        raise AssertionError("PER_DISTILL_STEP does not count the net's layer norms")
    teacher_model = create_model(TEACHER_MODEL, dtype=torch.bfloat16, seed=0)
    forward = make_teacher(teacher_model)
    per_step = dict(PER_DISTILL_STEP, batch_norm_apply=sum(
        isinstance(m, BatchNorm) for m in teacher_model.modules()))
    events = []

    def teacher(images):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        logits = forward(images)
        end.record()
        events.append((start, end))
        return logits

    ocfg = OptimConfig(base_lr=5e-4, warmup_epochs=5, epochs=300, steps_per_epoch=1000,
                       global_batch_size=BATCH)
    cfg = TrainConfig(num_classes=1000, smoothing=0.1, **MIXUP, distill_alpha=0.5,
                      hard_distill=True, ema_decay=EMA_DECAY)
    step = make_train_step(model, make_optimizer(ocfg, model), cfg, schedule=lr_schedule(ocfg),
                           seed=0, teacher=teacher)
    images, labels = synthetic_batch(BATCH, 224, 5)
    out = run_steps("distill", step, images, labels, lambda: None, steps, warmup, per_step)
    check_ema("distill", step)
    torch.cuda.synchronize()
    timed = [s.elapsed_time(e) for s, e in events[warmup:warmup + steps]]
    out["per_step"] = per_step
    out["teacher_ms"] = sum(timed) / len(timed)
    out["teacher_share"] = out["teacher_ms"] / out["step_ms"]
    out["teacher_params"] = sum(p.numel() for p in teacher_model.parameters())
    # the teacher's forward alone under the profiler, by kernel class
    x = normalize(images, cfg)
    busy_ms, wall_ms, classes, rows = profile_kernels(lambda: forward(x))
    out["teacher_profile"] = {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
                              "by_class_ms": classes, "top_kernels": rows}
    log("distill: the teacher's forward alone, profiled: " + ", ".join(
        f"{c} {ms:.1f}" for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]))
        + f" ({busy_ms:.1f} ms device-busy)")
    return out



def host_cores() -> int:
    return len(os.sched_getaffinity(0))


def make_folder(root: str) -> float:
    """The synthetic image folder of the loader and cli phases
    (``make_synthfolder``, one process per host core) with its holdout split
    (``build_subsets``); returns the seconds it took."""
    import contextlib

    from vit_search_torch.data import build_subsets
    from vit_search_torch.tools.make_synthfolder import generate

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        generate(root, num_classes=FOLDER_CLASSES, train_per_class=FOLDER_TRAIN,
                 val_per_class=0, size=FOLDER_SIZE, seed=0, workers=host_cores())
    build_subsets(root, per_class=FOLDER_HOLDOUT, seed=0)
    return time.perf_counter() - t0


def _make_folder_into(folder: str, seconds) -> None:
    seconds.value = make_folder(folder)


def start_folder(folder: str):
    """:func:`make_folder` in a process of its own, so that the host makes the
    folder while the card runs the kernel checks: ``(process, seconds)``,
    where ``seconds.value`` receives its time once it ends."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    seconds = ctx.Value("d", -1.0)
    proc = ctx.Process(target=_make_folder_into, args=(folder, seconds))
    proc.start()
    return proc, seconds


def stop(proc, scratch: str) -> None:
    """End ``proc`` if it still runs and remove ``scratch``."""
    if proc.is_alive():
        proc.terminate()
    proc.join()
    shutil.rmtree(scratch, ignore_errors=True)


def loader(folder: str):
    """super_net/tiny.sh's input pipeline on the synthetic folder's
    sub-train split: ``TrainTransform`` at 224 px with RandAugment
    ``rand-m9-mstd0.5-inc1``, batch ``BATCH``, the process backend with one
    worker per host core. A job is a whole batch, so an epoch of 5 batches
    decodes them side by side and every rate here is a cold epoch's. First
    the loader alone over one epoch (and, for comparison, on the thread
    backend with as many threads); then an epoch of the train phase's step
    fed from it through the device feed, timed from the epoch's start
    (K1-K4 launches exact); then one step, its batch's wait included, under
    the profiler: the device's idle share while the loader feeds it.
    ``tools/loader_check.py`` measures the loader at small batches, where
    the workers' rate is steady."""
    import numpy as np
    import torch
    from vit_search_torch import data
    from vit_search_torch.ops import kernels

    cores = host_cores()
    ds = data.build_dataset(True, data_set="IMNET", data_path=folder, use_holdout=True,
                            transform=data.TrainTransform(size=224,
                                                          rand_augment=LOADER_AUGMENT))

    def epoch_alone(backend: str, epoch: int):
        """One epoch of the loader alone: (images, seconds, first batch's seconds)."""
        pipe = data.DataLoader(ds, data.ShardedSampler(len(ds), 1, 0), BATCH,
                               num_workers=cores, drop_last=True, seed=0,
                               worker_backend=backend)
        pipe.set_epoch(epoch)
        t0 = time.perf_counter()
        first_s, seen = None, 0
        for images, labels in pipe:
            if images.shape != (BATCH, 224, 224, 3) or images.dtype != np.uint8:
                raise AssertionError(f"loader: a batch of {images.shape} {images.dtype}")
            first_s = first_s or time.perf_counter() - t0
            seen += len(labels)
        return seen, time.perf_counter() - t0, first_s, pipe

    seen, loader_s, first_s, pipe = epoch_alone("process", 0)
    thread_seen, thread_s, _, _ = epoch_alone("thread", 0)
    out = {"host_cpu_count": os.cpu_count(), "host_cores": cores, "images": len(ds),
           "classes": ds.num_classes, "batches_per_epoch": len(pipe),
           "loader_imgs_per_s": seen / loader_s, "loader_first_batch_s": first_s,
           "loader_thread_backend_imgs_per_s": thread_seen / thread_s}
    log(f"loader alone: {seen} images in {loader_s:.2f} s on {cores} worker processes "
        f"(first batch {first_s:.2f} s); {thread_s:.2f} s on {cores} threads")

    # an epoch of the train phase's step fed by the loader, timed from the
    # start of the epoch (the workers' start and first batch included)
    step, sched = supernet_step()
    rng = np.random.default_rng(0)
    pipe.set_epoch(1)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(images, labels, sched.sample_packed(rng, BATCH))
               for images, labels in data.prefetch_to_device(pipe, "cuda")]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    losses = [float(m["loss"]) for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"loader-fed steps: non-finite loss: {losses}")
    check_launches(launches, PER_STEP, len(metrics), "loader-fed steps")

    # the profiled step: the third of a new epoch, so the workers are up
    pipe.set_epoch(2)
    feed = data.prefetch_to_device(pipe, "cuda")
    for _ in range(2):
        step(*next(feed), sched.sample_packed(rng, BATCH))
    busy_ms, wall_ms, classes, rows = profile_kernels(
        lambda: step(*next(feed), sched.sample_packed(rng, BATCH)))
    feed.close()
    out.update(steps=len(metrics), step_imgs_per_s=BATCH * len(metrics) / elapsed,
               step_ms=1e3 * elapsed / len(metrics), losses=losses, launches=launches,
               profiled_step={"device_busy_ms": busy_ms, "wall_ms": wall_ms,
                              "idle_share": 1.0 - busy_ms / wall_ms, "by_class_ms": classes,
                              "top_kernels": rows})
    return out


def with_flags(argv: list, flags: dict) -> list:
    """``argv`` with each flag of ``flags`` set to its value (replaced where
    present, else added)."""
    argv = list(argv)
    for flag, value in flags.items():
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    return argv


def cli(folder: str, root: str):
    """``vit_search_torch.cli.train.main`` in-process on the card with
    super_net/tiny.sh's own arguments, only the data path, batch ``BATCH``,
    ``CLI_EPOCHS`` epochs of ``CLI_STEPS`` steps, the output directory and
    one loader worker per host core set here: epoch 0, then a SIGTERM once
    its log line is written (the run checkpoints in epoch 1 and returns),
    ``--resume auto`` for the rest of epoch 1, then ``--eval`` from the last
    checkpoint. K1-K4 launches are exact: 18/18/39/39 per train step, K1 18
    and K3 39 per eval forward."""
    import contextlib
    import signal
    import threading

    from vit_search_torch.cli import train as train_cli
    from vit_search_torch.ops import kernels
    from vit_search_torch.train import restore_raw

    out_dir = os.path.join(root, "cli")
    argv = with_flags(script_command(SUPERNET_SCRIPT)[1], {
        "--data-path": folder, "--batch-size": str(BATCH), "--epochs": str(CLI_EPOCHS),
        "--max-steps-per-epoch": str(CLI_STEPS), "--output_dir": out_dir,
        "--num_workers": str(host_cores())})
    parser = train_cli.get_args_parser()
    log_path = os.path.join(out_dir, "log.txt")
    armed = threading.Event()
    armed.set()

    def preempt():
        deadline = time.time() + 600
        while armed.is_set() and time.time() < deadline:
            if os.path.exists(log_path) and os.path.getsize(log_path):
                if armed.is_set():
                    os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.01)

    def run(extra):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):   # the CLI's console log
            result = train_cli.main(parser.parse_args(argv + extra))
        return result, time.perf_counter() - t0

    kernels.reset_launches()
    killer = threading.Thread(target=preempt, daemon=True)
    killer.start()
    try:
        first, first_s = run([])
    finally:
        armed.clear()
        killer.join(timeout=5)
    if not first.get("preempted") or first["epoch"] != 1:
        raise AssertionError(f"cli: the SIGTERM did not preempt epoch 1: {first}")
    meta = restore_raw(os.path.join(out_dir, "checkpoints", "checkpoint"))["metadata"]
    if (meta.get("preempted_step"), meta.get("steps_per_epoch"), meta.get("epoch")) != (
            CLI_STEPS + first["step"], CLI_STEPS, 0):
        raise AssertionError(f"cli: preemption checkpoint metadata {meta}")
    resumed, resumed_s = run(["--resume", "auto"])
    evaluated, eval_s = run(["--resume", "auto", "--eval"])
    launches = {k.name: k.launches for k in kernels.KERNELS}

    with open(log_path) as f:
        lines = [json.loads(line) for line in f]
    if [line["epoch"] for line in lines] != list(range(CLI_EPOCHS)) or resumed["epoch"] != 1:
        raise AssertionError(f"cli: logged epochs {[line['epoch'] for line in lines]}, "
                             f"the resumed run ended at {resumed.get('epoch')}")
    losses = [line["train_loss"] for line in lines]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cli: non-finite loss: {losses}")
    acc1 = evaluated["eval"]["acc1"]
    if not 0.0 <= acc1 <= 100.0:
        raise AssertionError(f"cli: eval acc1 {acc1}")
    val_bs = parser.parse_args(argv).val_bs
    forwards = 3 * math.ceil(FOLDER_CLASSES * FOLDER_HOLDOUT / val_bs)  # epochs 0, 1; --eval
    train_steps = CLI_EPOCHS * CLI_STEPS
    want = {name: PER_STEP[name] * train_steps + PER_FORWARD["fused"][name] * forwards
            for name in KERNEL_NAMES}
    if launches != want:
        raise AssertionError(f"cli: launches {launches}, expected {want} ({train_steps} "
                             f"train steps, {forwards} eval forwards)")
    return {"argv": argv, "train_steps": train_steps, "eval_forwards": forwards,
            "launches": launches, "preempted_at": first, "preemption_metadata": meta,
            "epochs": lines, "epoch_imgs_per_s": [line["train_imgs_per_sec"] for line in lines],
            "eval": evaluated["eval"], "seconds": {"first": first_s, "resumed": resumed_s,
                                                   "eval": eval_s}}

def dist_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of the ``dist`` phase, in a process of its own on the one
    card, joined over gloo through the file ``store``: ``DIST_STEPS`` train
    phase steps on its ``DIST_BATCH`` rows of the train phase's global batch,
    the gather of the batch and the gradients' all-reduce timed alone at the
    step's sizes, then the search phase's first generation (the native
    generators' ``POPULATION`` random candidates) scored on its share of the
    sub-val batches (batches ``rank::world``). Writes its numbers to
    ``out/dist_rank<rank>.json``."""
    import gc

    import numpy as np
    import torch
    from vit_search_torch import parallel
    from vit_search_torch.arch import ComputationEstimator, presets, spaces
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.ops import attention, kernels, masked_layer_norm, stats  # noqa: F401
    from vit_search_torch.search import BatchedSupernetEvaluator, PopulationEvolver
    from vit_search_torch.tools import attn_lab  # noqa: F401  (registers K10-K12)

    parallel.init_distributed(f"file://{store}", world, rank, local_rank=0, device="cuda",
                              backend="gloo")
    report = {"rank": rank, "group": parallel.describe()}
    step, sched = supernet_step()
    images, labels = synthetic_batch(BATCH, 224, 0)
    lo, hi = parallel.batch_slice(BATCH)
    images, labels = images[lo:hi].contiguous(), labels[lo:hi].contiguous()
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    metrics, report["step_s"] = [], []
    for _ in range(DIST_STEPS):
        parallel.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step(images, labels, sched.sample_packed(rng, BATCH)))
        torch.cuda.synchronize()
        report["step_s"].append(time.perf_counter() - t0)
    report["train_launches"] = {k.name: k.launches for k in kernels.KERNELS}
    report.update(dist_readings(step, metrics))
    report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()

    # the step's collectives alone, at its sizes: the uint8 batch's gather
    # (token mixup needs the global batch) and the one flat all-reduce of
    # the gradients
    grads = [p.grad for p in step.params]
    comm = {"gather_bytes": images.numel() * world, "grad_bytes": 4 * sum(g.numel() for g in grads)}
    for name, fn in (("gather_ms", lambda: parallel.all_gather(images)),
                     ("grad_all_reduce_ms", lambda: parallel.all_reduce_mean_(grads))):
        parallel.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COMM_REPS):
            fn()
        torch.cuda.synchronize()
        comm[name] = 1e3 * (time.perf_counter() - t0) / COMM_REPS
    report["collectives"] = comm
    del step, metrics, grads
    # the same steps again under each planted fault: the readings that the
    # limits must catch
    report["faults"] = {}
    for fault, plant in PLANTED_FAULTS.items():
        undo = plant()
        try:
            step, _ = supernet_step()
            rng = np.random.default_rng(0)
            metrics = [step(images, labels, sched.sample_packed(rng, BATCH))
                       for _ in range(DIST_STEPS)]
            report["faults"][fault] = dist_readings(step, metrics)
        finally:
            undo()
        del step, metrics
    gc.collect()
    torch.cuda.empty_cache()

    net, space = presets.SUPERNET_SR_TINY_MH, spaces.get_space("sr_tiny_mh")
    model = create_model(SEARCH_MODEL, network_def=net, dtype=torch.bfloat16, gelu="tanh",
                         seed=0, ln_route="fused")
    est = ComputationEstimator(distill=False, input_resolution=224, patch_size=14)
    evolver = PopulationEvolver(net, space, TINY_BUDGET, est, seed=0, backend="native")
    evolver.random_sample(POPULATION)
    defs = [ind.network_def for ind in evolver.popu]
    loader = sub_val_loader()[rank::world]
    evaluator = BatchedSupernetEvaluator(
        model, SupernetSchedules(net, space, example_per_arch=1, num_warmup_epochs=0),
        loader, arch_batch=ARCH_BATCH, score_head="cls")
    kernels.reset_launches()
    parallel.barrier()
    t0 = time.perf_counter()
    scores = evaluator.score(defs)
    torch.cuda.synchronize()
    report.update(score_s=time.perf_counter() - t0, backend=evolver.backend,
                  score_launches={k.name: k.launches for k in kernels.KERNELS},
                  forwards=-(-len(defs) // ARCH_BATCH) * len(loader),
                  network_defs=[repr(d) for d in defs], scores=list(map(float, scores)))
    with open(os.path.join(out, f"dist_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    parallel.shutdown()
    return 0


def dist_readings(step, metrics) -> dict:
    """What the dist phase holds two processes to one by: the steps' losses
    and grad norms and the conv stem's running batch statistics."""
    return {"losses": [float(m["loss"]) for m in metrics],
            "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "bn_stats": {name: b.tolist() for name, b in step.model.named_buffers()
                         if name.endswith(("running_mean", "running_var"))}}


def plant_local_bn():
    """Planted fault: the conv stem's batch statistics from this rank's rows
    alone. Returns its undo."""
    from types import SimpleNamespace

    from vit_search_torch.ops import batch_norm

    saved = batch_norm.parallel
    batch_norm.parallel = SimpleNamespace(sum_over_processes=lambda x: x,
                                          process_count=lambda: 1)
    return lambda: setattr(batch_norm, "parallel", saved)


def plant_local_drop_path():
    """Planted fault: drop-path keeps drawn at this rank's shape instead of
    cut from the global batch's (no ``RowShard``). Returns its undo."""
    from vit_search_torch.train import engine

    saved = engine.RowShard
    engine.RowShard = lambda generator, *rows: generator
    return lambda: setattr(engine, "RowShard", saved)


PLANTED_FAULTS = {"local_bn_stats": plant_local_bn, "local_drop_path": plant_local_drop_path}


def one_process_readings() -> dict:
    """:func:`dist_readings` of ``DIST_STEPS`` train phase steps on the
    whole global batch in this process."""
    import gc

    import numpy as np
    import torch

    step, sched = supernet_step()
    images, labels = synthetic_batch(BATCH, 224, 0)
    rng = np.random.default_rng(0)
    metrics = [step(images, labels, sched.sample_packed(rng, BATCH))
               for _ in range(DIST_STEPS)]
    out = dist_readings(step, metrics)
    del step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_gaps(got: dict, want: dict) -> dict:
    """Relative gaps of :func:`dist_readings`: the largest over the steps for
    the losses and grad norms, the largest by norm over the statistics."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    bn = [math.dist(got["bn_stats"][k], v) / math.hypot(*v) for k, v in want["bn_stats"].items()]
    return {"loss": max(map(rel, got["losses"], want["losses"])),
            "grad_norm": max(map(rel, got["grad_norms"], want["grad_norms"])),
            "bn_stats": max(bn)}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist(folder: str, root: str, search_fused: dict):
    """Two processes on the one card over gloo (``dist_worker``), held to one
    process on the same global data: losses, grad norms and the conv stem's
    running statistics within ``DIST_TOL`` of the train phase's first
    ``DIST_STEPS`` steps run again here (the same model, batch, counts and
    draws), and each of ``PLANTED_FAULTS`` caught; the first generation's scores
    equal to the fused-route search phase's (the same candidates, batches
    and forward shapes), both ranks equal bit for bit, K1-K4 18/18/39/39
    launches per rank-step and K1/K3 18/39 per scoring forward. Then ``python
    -m vit_search_torch.cli.launch`` under a torchrun environment of one
    process on NCCL: one epoch of ``LAUNCH_STEPS`` steps of
    super_net/tiny.sh on the cli phase's folder."""
    out = os.path.join(root, "dist")
    os.makedirs(out)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker",
                               str(r), str(DIST_PROCS), os.path.join(out, "store"), out],
                              cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(DIST_PROCS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    workers_s = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"dist: rank {r} exited {p.returncode}:\n{text[-6000:]}")
    ranks = []
    for r in range(DIST_PROCS):
        with open(os.path.join(out, f"dist_rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    for r in ranks[1:]:
        for key in ("losses", "grad_norms", "bn_stats", "scores", "network_defs"):
            if r[key] != r0[key]:
                raise AssertionError(f"dist: ranks disagree on {key}: {r0[key]} vs {r[key]}")
    one = one_process_readings()
    # the sound run within every limit; each planted fault caught, by the
    # ranks' disagreement or by a gap over its limit
    gaps = {"sound": dist_gaps(r0, one)}
    faults = {}
    for fault in PLANTED_FAULTS:
        got = [r["faults"][fault] for r in ranks]
        gaps[fault] = dist_gaps(got[0], one)
        faults[fault] = {"ranks_agree": all(g == got[0] for g in got),
                         "over": [k for k, tol in DIST_TOL.items() if gaps[fault][k] > tol]}
    print(f"dist: gaps of two processes to one (limits {json.dumps(DIST_TOL)}): "
          f"{json.dumps(gaps)}; planted faults {json.dumps(faults)}", flush=True)
    over = [k for k, tol in DIST_TOL.items() if gaps["sound"][k] > tol]
    if over:
        raise AssertionError(f"dist: two processes against one over the limits on {over}: "
                             f"{gaps['sound']}")
    missed = [f for f, v in faults.items() if v["ranks_agree"] and not v["over"]]
    if missed:
        raise AssertionError(f"dist: the limits do not catch the planted faults {missed}")
    first = search_fused["first_generation"]
    if r0["network_defs"] != first["network_defs"] or r0["backend"] != "native":
        raise AssertionError("dist: the native generators drew other candidates than the "
                             "search phase's")
    if r0["scores"] != first["scores"]:
        raise AssertionError(f"dist: scores {r0['scores']} vs one process {first['scores']}")
    for r in ranks:
        check_launches(r["train_launches"], PER_STEP, DIST_STEPS, f"rank {r['rank']} steps")
        check_launches(r["score_launches"], PER_FORWARD["fused"], r["forwards"],
                       f"rank {r['rank']} scoring forwards")
    launches = {name: r0["train_launches"][name] + r0["score_launches"][name]
                for name in KERNEL_NAMES}
    # the last step's time, the slower rank's: the first pays the libraries'
    # warm-up
    step_s = max(r["step_s"][-1] for r in ranks)

    # cli.launch as torchrun starts it, one process, NCCL
    launch_out = os.path.join(root, "launch")
    argv = with_flags(script_command(SUPERNET_SCRIPT)[1], {
        "--data-path": folder, "--batch-size": str(BATCH), "--epochs": "1",
        "--max-steps-per-epoch": str(LAUNCH_STEPS), "--output_dir": launch_out,
        "--num_workers": str(host_cores())})
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vit_search_torch.cli.launch", *argv],
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    launch_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dist: cli.launch exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(launch_out, "verbose.log")) as f:
        group = next((line for line in f if "over nccl" in line), None)
    if group is None or "rank 0 of 1 over nccl" not in group:
        raise AssertionError(f"dist: cli.launch did not run over NCCL: {group}")
    with open(os.path.join(launch_out, "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    if [line["epoch"] for line in lines] != [0] or not math.isfinite(lines[0]["train_loss"]):
        raise AssertionError(f"dist: cli.launch logged {lines}")
    return {"ranks": ranks, "launches": launches, "workers_s": workers_s,
            "two_process_imgs_per_s": BATCH / step_s, "one_process": one,
            "gaps": gaps, "planted_faults": faults,
            "launch": {"argv": argv, "seconds": launch_s, "group": group.strip(),
                       "epochs": lines}}


def sub_val_loader():
    """Synthetic sub-val batches of uint8 images on the card, the same at
    every call; the last batch has ``LAST_VALID`` valid rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    loader = []
    for i in range(VAL_BATCHES):
        valid = torch.ones(VAL_BATCH, device="cuda")
        if i == VAL_BATCHES - 1:
            valid[LAST_VALID:] = 0
        loader.append((torch.randint(0, 256, (VAL_BATCH, 224, 224, 3), dtype=torch.uint8,
                                     device="cuda", generator=gen),
                       torch.randint(0, 1000, (VAL_BATCH,), device="cuda", generator=gen),
                       valid))
    return loader


def chunk_forward(model, sched, defs, images):
    """One chunk's tiled forward, as the evaluator runs it: the logits (on the
    host) and the forward's time."""
    import numpy as np
    import torch
    from vit_search_torch.models import build_arch_masks
    from vit_search_torch.train import TrainConfig, normalize

    counts = sched.counts_for_subnets(defs)
    tiled = {"embed": np.repeat(counts["embed"], VAL_BATCH),
             "slots": {s: {k: np.repeat(v, VAL_BATCH) for k, v in site.items()}
                       for s, site in counts["slots"].items()}}
    masks = build_arch_masks(tiled, model.network_def, SEARCH_BATCH, device="cuda")
    x = normalize(images, TrainConfig()).repeat(ARCH_BATCH, 1, 1, 1)
    with torch.no_grad():
        logits = model.eval()(x, masks).float().cpu()
        ms = time_ms(lambda: model(x, masks), reps=2, warmup=0)
    return logits, ms


def python_generations(net, space, est):
    """Host seconds of the Python generators for the search phase's two
    generations (random ``POPULATION``, then ``MUTATIONS`` mutations and as
    many crossovers), scored by a deterministic stand-in for accuracy."""
    from vit_search_torch.search import PopulationEvolver

    evolver = PopulationEvolver(net, space, TINY_BUDGET, est, seed=0, backend="python")
    seconds = []
    for generation in range(2):
        t0 = time.perf_counter()
        if generation == 0:
            evolver.random_sample(POPULATION)
        else:
            evolver.evolve_sample(parent_size=PARENTS, mutate_prob=MUTATE_PROB,
                                  mutate_size=MUTATIONS)
        seconds.append(time.perf_counter() - t0)
        for ind in evolver.popu:
            ind.score = float(est(ind.network_def) % 997) / 10.0
        evolver.update_history()
    return seconds


def search(ln_route: str, card: str):
    """Score an evolutionary population on the full-width supernet with its
    masked LNs on ``ln_route``. Returns the report and one chunk's logits."""
    import gc

    import numpy as np
    import torch
    from vit_search_torch.arch import ComputationEstimator, presets, spaces
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.ops import kernels
    from vit_search_torch.search import (BatchedSupernetEvaluator, PopulationEvolver,
                                         gen_random_network_def)
    from vit_search_torch.search.generators import RESOURCE_LOWER_BOUND

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    net, space = presets.SUPERNET_SR_TINY_MH, spaces.get_space("sr_tiny_mh")
    model = create_model(SEARCH_MODEL, network_def=net, dtype=torch.bfloat16, gelu="tanh",
                         seed=0, ln_route=ln_route)
    sched = SupernetSchedules(net, space, example_per_arch=1, num_warmup_epochs=0,
                              arch_mode="multi")
    loader = sub_val_loader()
    evaluator = BatchedSupernetEvaluator(model, sched, loader, arch_batch=ARCH_BATCH,
                                         score_head="cls")
    est = ComputationEstimator(distill=False, input_resolution=224, patch_size=14)
    evolver = PopulationEvolver(net, space, TINY_BUDGET, est, seed=0, backend="native")
    if evolver.backend != "native":
        raise AssertionError(f"search: the evolver took the {evolver.backend} generators")

    # warm-up, and one chunk's logits for the cross-check of the two routes
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    check_defs = [gen_random_network_def(net, space, TINY_BUDGET, est, rng=rng)
                  for _ in range(ARCH_BATCH)]
    evaluator.score(check_defs)
    logits, chunk_ms = chunk_forward(model, sched, check_defs, loader[0][0])
    warm_s = time.perf_counter() - t0

    # the main path: generators on the host, scoring on the card
    gc.collect()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    gen_s = score_s = 0.0
    forwards = 0
    native_gen_s, first = [], {}
    for generation in range(2):
        t0 = time.perf_counter()
        if generation == 0:
            evolver.random_sample(POPULATION)
        else:
            evolver.evolve_sample(parent_size=PARENTS, mutate_prob=MUTATE_PROB,
                                  mutate_size=MUTATIONS)
        t1 = time.perf_counter()
        defs = [ind.network_def for ind in evolver.popu]
        scores = evaluator.score(defs)
        torch.cuda.synchronize()
        if generation == 0:
            first = {"network_defs": [repr(d) for d in defs], "scores": list(map(float, scores))}
        native_gen_s.append(t1 - t0)
        gen_s += t1 - t0
        score_s += time.perf_counter() - t1
        forwards += -(-len(defs) // ARCH_BATCH) * len(loader)
        for ind, sc in zip(evolver.popu, scores):
            ind.score = float(sc)
        evolver.update_history()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    candidates = evolver.history_popu
    lo = RESOURCE_LOWER_BOUND * TINY_BUDGET
    macs = [est(ind.network_def) for ind in candidates]
    if len(candidates) != POPULATION + 2 * MUTATIONS:
        raise AssertionError(f"{len(candidates)} candidates scored")
    if not all(lo <= m <= TINY_BUDGET for m in macs):
        raise AssertionError(f"candidate MACs outside [{lo}, {TINY_BUDGET}]: {macs}")
    if not all(math.isfinite(i.score) and 0.0 <= i.score <= 100.0 for i in candidates):
        raise AssertionError(f"scores outside [0, 100]: {[i.score for i in candidates]}")
    check_launches(launches, PER_FORWARD[ln_route], forwards, f"forwards on {ln_route}")
    mismatched = [ind.network_def for ind in candidates
                  if evolver.native.estimate_mac(ind.network_def) != est(ind.network_def)]
    if mismatched:
        raise AssertionError(f"native estimate_mac differs from the estimator on {mismatched}")
    python_gen_s = python_generations(net, space, est)
    # one chunk (a forward per sub-val batch) under the profiler
    busy_ms, wall_ms, classes, top = profile_kernels(lambda: evaluator.score(check_defs))

    # the reference search at the measured seconds per candidate-image
    # forwarded (a short last chunk forwards fewer) and per candidate
    ref = REFERENCE_SEARCH
    ref_candidates = ref["first"] + ref["generations"] * ref["per_generation"]
    ref_images = ref_candidates * -(-ref["sub_val_images"] // VAL_BATCH) * VAL_BATCH
    images = len(candidates) * VAL_BATCHES * VAL_BATCH
    valid_images = (VAL_BATCHES - 1) * VAL_BATCH + LAST_VALID
    out = {"ln_route": ln_route, "candidates": len(candidates), "forwards": forwards,
           "images_per_forward": SEARCH_BATCH, "valid_images": valid_images,
           "candidate_images_forwarded": images,
           "candidates_per_s": len(candidates) / score_s,
           "candidate_images_per_s": len(candidates) * valid_images / score_s,
           "score_s": score_s, "generator_s": gen_s, "warmup_s": warm_s,
           "generator_backend": evolver.backend,
           "generator_s_per_generation": {"native": native_gen_s, "python": python_gen_s},
           "first_generation": first,
           "max_memory_allocated_bytes": peak, "chunk_forward_ms": chunk_ms,
           "launches": launches, "macs_min_max": [min(macs), max(macs)],
           "best": {"score": evolver.best().score,
                    "network_def": repr(evolver.best().network_def)},
           "profiled_chunk": {"forwards": len(loader), "device_busy_ms": busy_ms,
                              "wall_ms": wall_ms, "by_class_ms": classes, "top_kernels": top},
           "reference_search": {**ref, "candidate_images_forwarded": ref_images,
                                "scoring_s": ref_images * score_s / images,
                                "generator_s": ref_candidates * gen_s / len(candidates)}}
    print(f"search, ln_route={ln_route}: {out['candidates_per_s']:.2f} candidates/s, "
          f"{out['candidate_images_per_s']:.1f} candidate-images/s ({len(candidates)} "
          f"candidates x {valid_images} images, {SEARCH_BATCH} images per forward), host "
          f"generators {gen_s:.3f} s, peak memory {peak / 2**30:.2f} GiB on {card}",
          flush=True)
    print(f"native, ln_route={ln_route}: {len(candidates)} candidates in the MAC band, native "
          f"estimate_mac equal to the estimator on each; host generator s per generation "
          f"(random {POPULATION}, then {MUTATIONS} + {MUTATIONS}): native "
          + " / ".join(f"{v:.4f}" for v in native_gen_s) + ", python "
          + " / ".join(f"{v:.4f}" for v in python_gen_s) + f" on {card}", flush=True)
    n = len(loader)
    by_class = ", ".join(f"{c} {ms / n:.1f}" for c, ms in sorted(classes.items(),
                                                                   key=lambda kv: -kv[1]))
    log(f"search, ln_route={ln_route}: {1e3 * score_s * SEARCH_BATCH / images:.1f} ms per "
        f"{SEARCH_BATCH} candidate-images ({chunk_ms:.1f} ms for the cross-check chunk's "
        f"forward alone); profiled, per full forward: {busy_ms / n:.1f} ms device-busy of "
        f"{wall_ms / n:.1f} ms ({by_class}); the reference search ({ref_candidates} "
        f"candidates, {ref_images} candidate-images forwarded) would take "
        f"{out['reference_search']['scoring_s'] / 3600:.2f} h of scoring and "
        f"{out['reference_search']['generator_s']:.0f} s of generators")
    return out, logits


def kernel_attention_blocks(network_def, img_size: int, patch_size: int = 14,
                            num_tokens: int = 1) -> int:
    """The existing attention blocks of ``network_def`` at ``img_size`` that
    take the fused kernel: ``ops.attention.supported`` at each stage's token
    count and head dim (below N = 8 the model runs the plain version)."""
    from vit_search_torch.arch import network_def as nd
    from vit_search_torch.ops.attention import supported

    grid, count = img_size // patch_size, 0
    for block in network_def[1:-1]:
        if nd.block_type(block) == nd.TRANSFORMER:
            tdef = nd.transformer_def(block)
            count += bool(tdef.exists and supported(grid * grid + num_tokens, tdef.head_dim, 0.0))
        else:
            grid //= 2
    return count


def start_study(root: str):
    """Start the study of :func:`study` in a process session of its own, its
    output to a file: ``(process, argv, start time)``."""
    out = os.path.join(root, "study")
    argv = [sys.executable, "-m", "vit_search_torch.tools.accuracy_study", "--root", out,
            *[a for kv in STUDY_FLAGS.items() for a in kv], "--num-workers", str(host_cores())]
    with open(os.path.join(root, "study_stdout.txt"), "w") as f:
        proc = subprocess.Popen(argv, cwd=HERE, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return proc, argv, time.perf_counter()


def end_session(proc) -> None:
    """Kill ``proc``'s process session (it and the processes it started) if
    it still runs."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def study(root: str, started):
    """``python -m vit_search_torch.tools.accuracy_study`` as users run it, in
    a subprocess on the card at ``STUDY_FLAGS``' scale with one loader
    worker per host core: the data, the supernet (``cli.train``), the search
    (``cli.evo_search`` on the checkpoint the supernet run wrote), the winner
    and the random control retrained, the 168 px finetune (``cli.train
    --finetune``) and ``--eval``. The study must exit 0 with every summary
    key, both nets within the scaled budget, every loss finite and every
    top-1 in [0, 100]; the port's ``render_results`` must render all five
    sections. Then ``tools.gelu_delta.main`` in this process on the
    retrained winner at 112 px: finite numbers, and K1 launched exactly
    twice (one forward per GELU form) per attention block of the winner
    that takes the kernel (at 112 px the third stage has N = 5 tokens,
    which run the plain version), and K3's dense mode twice per layer norm
    (``dense_lns``), no other kernel. The subprocesses' launches cannot be
    read from here; the cli phase counts the CLIs' own."""
    import contextlib

    from vit_search_torch.arch import network_def as nd
    from vit_search_torch.arch import parse_network_def
    from vit_search_torch.ops import kernels
    from vit_search_torch.tools import gelu_delta, render_results, study_timing

    proc, argv, t0 = started
    out = os.path.join(root, "study")
    try:
        proc.wait(timeout=max(1.0, STUDY_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        end_session(proc)
        raise AssertionError(f"study: not done in {STUDY_TIMEOUT_S} s")
    wall_s = time.perf_counter() - t0
    with open(os.path.join(root, "study_stdout.txt")) as f:
        stdout = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"study: exit {proc.returncode}; its output ends\n"
                             f"{stdout[-4000:]}")
    timing = study_timing.parse(stdout)
    with open(os.path.join(out, "study_summary.json")) as f:
        summary = json.load(f)
    missing = [k for k in STUDY_KEYS if k not in summary]
    if missing:
        raise AssertionError(f"study: the summary lacks {missing}")
    if summary["finetune_size"] != STUDY_FINETUNE_SIZE:
        raise AssertionError(f"study: finetune at {summary['finetune_size']} px")
    for tag in ("winner", "random"):
        if not 0 < summary[f"{tag}_mac"] <= STUDY_BUDGET:
            raise AssertionError(f"study: {tag} MACs {summary[f'{tag}_mac']} over "
                                 f"the budget {STUDY_BUDGET:.0f}")
    curves = {k: v for k, v in summary.items() if k.endswith("_curve")}
    for name, curve in curves.items():
        if not curve or not all(math.isfinite(e["train_loss"]) and 0.0 <= e["test_acc1"] <= 100.0
                                for e in curve):
            raise AssertionError(f"study: {name} {curve}")
    markdown_path = os.path.join(out, "RESULTS.md")
    with contextlib.redirect_stdout(sys.stderr):
        render_results.main([os.path.join(out, "study_summary.json"), markdown_path])
    with open(markdown_path) as f:
        markdown = f.read()
    absent = [h for h in STUDY_SECTIONS if h not in markdown]
    if absent:
        raise AssertionError(f"study: the rendered markdown lacks {absent}")

    def_file = os.path.join(out, "winner_def.txt")
    with open(def_file, "w") as f:
        f.write(summary["winner_def"])
    winner = parse_network_def(summary["winner_def"])
    blocks = kernel_attention_blocks(winner, STUDY_SIZE)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        gelu = gelu_delta.main([os.path.join(out, "retrain_winner"), os.path.join(out, "data"),
                                def_file, str(STUDY_SIZE)])
    gelu_s = time.perf_counter() - t0
    counted = {k.name: k.launches for k in kernels.KERNELS}
    launches = {name: counted.get(name, 0) for name in KERNEL_NAMES}
    want = per_pass(attention_qkv_fwd=2 * blocks, layer_norm_fwd=2 * dense_lns(winner),
                    batch_norm_apply=2 * stem_norms(winner))
    if launches != want:
        raise AssertionError(f"study: gelu_delta launches {launches}, expected {want} "
                             f"(2 forwards x {blocks} attention blocks on the kernel and "
                             f"{dense_lns(winner)} layer norms)")
    if not all(math.isfinite(v) for v in gelu.values()):
        raise AssertionError(f"study: gelu_delta {gelu}")
    return {"argv": argv[1:], "wall_s": wall_s, "timing": timing, "summary": summary,
            "markdown": markdown, "gelu_delta": gelu, "gelu_delta_s": gelu_s,
            "winner_attention_blocks": nd.existing_depth(winner),
            "kernel_attention_blocks": blocks, "launches": launches}


def recipe_argv(script: str, data_path: str, workers: int):
    """``(cli, argv)`` of a published script as the recipes phase runs it:
    the script's own arguments with IMAGENET_PATH set to ``data_path``,
    MODEL_PATH (the searches) to ``RECIPE_CHECKPOINT`` in the directory that
    the script's default names, ``workers`` loader workers, one epoch of
    ``RECIPE_STEPS`` steps (training, not ``--eval``), the population of
    ``RECIPE_SEARCH`` (searches), and ``RECIPE_BATCH_CUTS``' batch where it
    names the script. Needs no card."""
    path = os.path.join(RECIPE_DIR, script)
    _, own = script_command(path)
    env = {"IMAGENET_PATH": data_path}
    if "--model-path" in own:
        default = own[own.index("--model-path") + 1]
        env["MODEL_PATH"] = os.path.join(os.path.dirname(default), RECIPE_CHECKPOINT)
    cli, argv = script_command(path, env)
    flags = {"--num_workers": str(workers)}
    if cli == "evo_search":
        flags.update(RECIPE_SEARCH)
    elif "--eval" not in argv:
        flags.update({"--epochs": str(RECIPE_EPOCHS), "--max-steps-per-epoch": str(RECIPE_STEPS)})
    if script in RECIPE_BATCH_CUTS:
        flags["--batch-size"] = str(RECIPE_BATCH_CUTS[script])
    return cli, with_flags(argv, flags)


def recipe_reads(argv: list) -> list:
    """The checkpoint directories a recipe's arguments read."""
    return [argv[argv.index(flag) + 1] for flag in ("--model-path", "--finetune", "--resume")
            if flag in argv]


def dense_lns(network_def) -> int:
    """The layer norms of a net: two per transformer block, one per
    spatial-reduction block, one final."""
    from vit_search_torch.arch import network_def as nd

    return (2 * nd.existing_depth(network_def) + 1
            + sum(nd.block_type(b) == nd.SPATIAL_REDUCTION for b in network_def))


def stem_norms(network_def) -> int:
    """The batch norms of a net: a conv stem's, none in a linear stem."""
    from vit_search_torch.arch import network_def as nd

    return 0 if nd.block_type(network_def[0]) == nd.LINEAR_EMBED else STEM_NORMS


def recipe_launches(network_def, img_size: int, masked: bool):
    """Launches per train step and per eval (or scoring) forward of a recipe's
    net, counted from its network_def: K1/K2 on each attention block that
    takes the kernel (N >= 8); K3/K4 on each layer norm (``dense_lns``),
    masked where ``masked`` (a supernet), else in their dense mode; B1/B2 on
    a conv stem's norms (``stem_norms``)."""
    attention = kernel_attention_blocks(network_def, img_size)
    lns, norms = dense_lns(network_def), stem_norms(network_def)
    fwd, bwd = (("masked_layer_norm_fwd", "masked_layer_norm_bwd") if masked
                else ("layer_norm_fwd", "layer_norm_bwd"))
    return (with_stem(per_pass(attention_qkv_fwd=attention, attention_qkv_bwd=attention,
                               **{fwd: lns, bwd: lns}), norms, True),
            with_stem(per_pass(attention_qkv_fwd=attention, **{fwd: lns}), norms, False))


def net_stages(network_def, img_size: int, patch_size: int = 14) -> list:
    """Each stage of a net at ``img_size``: ``{"N", "C", "H", "D",
    "blocks"}``, its token count, embedding width, widest attention's heads
    and head dim, and its transformer blocks."""
    from vit_search_torch.arch import network_def as nd

    grid, stages, n = img_size // patch_size, [], None
    for block in network_def[1:-1]:
        if nd.block_type(block) != nd.TRANSFORMER:
            grid //= 2
            continue
        t = nd.transformer_def(block)
        if n != grid * grid + 1:
            n = grid * grid + 1
            stages.append({"N": n, "C": t.embed_dim, "H": 0, "D": t.head_dim, "blocks": 0})
        st = stages[-1]
        st["blocks"] += 1
        if t.num_heads > st["H"]:
            st.update(H=t.num_heads, D=t.head_dim)
    return stages


def recipe_stages(script: str):
    """``[(N, C, heads, head_dim)]`` of each stage of a recipe's net at its
    input size, from its network_def (``net_stages``)."""
    from vit_search_torch.arch import parse_network_def

    _, argv = recipe_argv(script, "", 1)
    net = parse_network_def(argv[argv.index("--network-def") + 1])
    size = int(argv[argv.index("--input-size") + 1]) if "--input-size" in argv else 224
    return [(st["N"], st["C"], st["H"], st["D"]) for st in net_stages(net, size)]


def recipe_data(folder: str, root: str) -> str:
    """The recipes' data: a view of ``folder`` whose ``train`` and ``val``
    are its ``sub-train`` and ``sub-val`` (the scripts without
    ``--use-holdout``), beside the two under their own names."""
    view = os.path.join(root, "recipes_data")
    os.makedirs(view)
    for name, target in (("train", "sub-train"), ("val", "sub-val"), ("sub-train", "sub-train"),
                         ("sub-val", "sub-val")):
        os.symlink(os.path.join(folder, target), os.path.join(view, name))
    return view


def search_candidates(args) -> list:
    """``[(network_def, score)]`` of every generation a search CLI run wrote."""
    import pickle

    out = []
    for i in range(args.search_iter):
        with open(os.path.join(args.output_dir, f"iter@{i}_popu.pickle"), "rb") as f:
            out.append(pickle.load(f))
    return out


def recipes(folder: str, root: str):
    """The 24 published scripts through the port's CLIs, in ``RECIPES``'
    order, in this process with the working directory at a temporary root
    (``recipe_argv``: the scripts' own arguments but for the overrides of
    ``RECIPE_OVERRIDES``). For each script: it returns without an exception;
    every loss it logs is finite; every eval's acc1 (the per-epoch eval, the
    EMA's, ``--eval``) is in [0, 100]; every search candidate is within its
    MAC band and scores in [0, 100]; the checkpoints that later scripts read
    from its output directory exist; K1-K4 launch exactly their counts per
    train step and per eval or scoring forward (``recipe_launches``); its
    peak memory is under the card's. One line per script on stderr."""
    import contextlib
    import gc

    import torch
    from vit_search_torch import models
    from vit_search_torch.arch import ComputationEstimator, parse_network_def
    from vit_search_torch.cli import evo_search as evo_cli
    from vit_search_torch.cli import train as train_cli
    from vit_search_torch.ops import kernels
    from vit_search_torch.search.generators import RESOURCE_LOWER_BOUND

    data_path = recipe_data(folder, root)
    work = os.path.join(root, "recipes")
    os.makedirs(work)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    train_images = FOLDER_CLASSES * (FOLDER_TRAIN - FOLDER_HOLDOUT)
    val_images = FOLDER_CLASSES * FOLDER_HOLDOUT
    commands = [(script, *recipe_argv(script, data_path, host_cores())) for script in RECIPES]
    runs, outputs, cwd, t_phase = {}, set(), os.getcwd(), time.perf_counter()
    os.chdir(work)
    try:
        for i, (script, cli, argv) in enumerate(commands):
            module = train_cli if cli == "train" else evo_cli
            args = module.get_args_parser().parse_args(argv)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):   # the CLI's console log
                result = module.main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counted = {k.name: k.launches for k in kernels.KERNELS}
            launches = {name: counted.get(name, 0) for name in KERNEL_NAMES}

            net = parse_network_def(args.network_def)
            masked = cli == "evo_search" or models.is_supernet_model(args.model)
            per_step, per_forward = recipe_launches(net, args.input_size, masked)
            run = {"cli": cli, "argv": argv, "seconds": seconds, "peak_bytes": peak,
                   "launches": launches, "per_step": per_step, "per_forward": per_forward}
            if cli == "train":
                if args.eval:
                    steps, passes, accs = 0, 1, [result["eval"]["acc1"]]
                else:
                    steps = args.epochs * min(args.max_steps_per_epoch,
                                              train_images // args.batch_size)
                    passes = args.epochs * (1 + bool(args.model_ema)) + bool(args.finetune)
                    accs = [result["test_acc1"]] + ([result["ema_test_acc1"]]
                                                   if args.model_ema else [])
                    if not math.isfinite(result["train_loss"]):
                        raise AssertionError(f"recipes: {script}: loss {result['train_loss']}")
                    run.update(train_loss=result["train_loss"],
                               imgs_per_s=result["train_imgs_per_sec"])
                forwards = passes * math.ceil(val_images / args.val_bs)
                run.update(batch=args.batch_size, acc1=accs)
                if not all(0.0 <= a <= 100.0 for a in accs):
                    raise AssertionError(f"recipes: {script}: acc1 {accs}")
            else:
                generations = search_candidates(args)
                est = ComputationEstimator(distill="distill" in args.model,
                                           input_resolution=args.input_size,
                                           patch_size=args.patch_size or 14)
                lo, hi = RESOURCE_LOWER_BOUND * args.constraint_value, args.constraint_value
                sizes = [args.init_popu_size] + [2 * args.mutate_size] * (args.search_iter - 1)
                macs = [est(d) for gen in generations for d, _ in gen]
                scores = [s for gen in generations for _, s in gen]
                if [len(gen) for gen in generations] != sizes:
                    raise AssertionError(f"recipes: {script}: generations of "
                                         f"{[len(g) for g in generations]}, expected {sizes}")
                if not all(lo <= m <= hi for m in macs):
                    raise AssertionError(f"recipes: {script}: MACs outside [{lo}, {hi}]: {macs}")
                if not all(0.0 <= s <= 100.0 for s in scores):
                    raise AssertionError(f"recipes: {script}: scores {scores}")
                steps = 0
                forwards = (sum(-(-n // args.arch_batch) for n in sizes)
                            * math.ceil(val_images / args.val_bs))
                run.update(batch=args.val_bs * args.arch_batch, candidates=len(macs),
                           candidates_per_s=len(macs) / seconds, macs=[min(macs), max(macs)],
                           best_score=result["best_score"])
            want = {name: per_step[name] * steps + per_forward[name] * forwards
                    for name in KERNEL_NAMES}
            if launches != want:
                raise AssertionError(f"recipes: {script}: launches {launches}, expected {want} "
                                     f"({steps} train steps, {forwards} forwards)")
            if peak >= card_bytes:
                raise AssertionError(f"recipes: {script}: peak {peak} B of the card's "
                                     f"{card_bytes}")
            # the checkpoints that later scripts read from this one's output;
            # an output no later script reads is removed (the machine's disk
            # holds a few of the scripts' states, not all of them)
            if getattr(args, "output_dir", ""):
                outputs.add(args.output_dir.rstrip("/"))
            reads = [path for _, _, later in commands[i + 1:] for path in recipe_reads(later)]
            for path in reads:
                if args.output_dir and path.startswith(args.output_dir.rstrip("/") + "/"):
                    if not os.path.isfile(os.path.join(path, "state.pt")):
                        raise AssertionError(f"recipes: {script} left no {path}")
            for out in sorted(outputs):
                if not any(path.startswith(out + "/") for path in reads):
                    shutil.rmtree(out)
                    outputs.discard(out)
            run.update(steps=steps, forwards=forwards)
            runs[script] = run
            cut = (f" (cut from the script's {script_batch(script)}: one card)"
                   if script in RECIPE_BATCH_CUTS else "")
            rate = (f"throughput {run['imgs_per_s']:.1f} imgs/s" if "imgs_per_s" in run
                    else f"{run['candidates']} candidates, {run['candidates_per_s']:.2f}/s"
                    if cli == "evo_search" else "eval only")
            log(f"recipes: {script}: batch {run['batch']}{cut}, val-bs {args.val_bs}, {steps} "
                f"steps, {forwards} "
                f"eval forwards, {rate}, acc1 {run.get('acc1', run.get('best_score'))}, peak "
                f"{peak / 2**30:.2f} GiB, K1/K2/K3/K4 " + "/".join(
                    str(launches[k]) for k in KERNEL_NAMES[:4]) + ", dense K3/K4 "
                f"{launches['layer_norm_fwd']}/{launches['layer_norm_bwd']}, {seconds:.1f} s")
    finally:
        os.chdir(cwd)
    return {"scripts": runs, "seconds": time.perf_counter() - t_phase}


def script_batch(script: str) -> int:
    """A published script's own ``--batch-size``."""
    _, argv = script_command(os.path.join(RECIPE_DIR, script))
    return int(argv[argv.index("--batch-size") + 1])


def recipe_profile(script: str, steps: int, warmup: int):
    """A token-mixup supernet recipe's train step (``supernet_step`` with the
    script's net, space, batch, examples per architecture, drop path, GELU
    and patch length) on device batches, no host decode, timed by
    ``run_steps`` with one step under the profiler."""
    import numpy as np
    from vit_search_torch.arch import parse_network_def
    from vit_search_torch.cli import train as train_cli

    _, argv = recipe_argv(script, "", 1)
    args = train_cli.get_args_parser().parse_args(argv)
    net = parse_network_def(args.network_def)
    step, sched = supernet_step(net, args.search_space, args.batch_size, args.example_per_arch,
                                args.drop_path, args.gelu, args.mixup_patch_len)
    images, labels = synthetic_batch(args.batch_size, args.input_size, 6)
    rng = np.random.default_rng(0)
    return run_steps(script, step, images, labels,
                     lambda: sched.sample_packed(rng, args.batch_size), steps, warmup,
                     recipe_launches(net, args.input_size, True)[0])


def k2_route_by_name(n: int, h: int, d: int, batch: int) -> dict:
    """K2's launches by kernel name over one bf16 forward and backward at
    ``(batch, N, heads, head_dim)`` through ``fused_attention_qkv``, under
    the profiler, against the route ``backward_is_split`` gives: the
    one-launch body (``attn_bwd_kernel``) or the split route
    (``attn_split_dq_kernel`` then ``attn_split_dkv_kernel``)."""
    import torch
    from vit_search_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(n + h + d)
    qkv = torch.randn(batch, n, 3 * h * d, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(batch, n, h * d, device="cuda", generator=gen).to(torch.bfloat16)
    leaf = qkv.requires_grad_()

    def step():   # through autograd, as the model calls it
        torch.autograd.grad(A.fused_attention_qkv(leaf, d ** -0.5, h), leaf, do)

    # the profiler now and then returns a trace without device events (the
    # card's kernel records missed): profile again until it holds some
    for _ in range(5):
        _, _, _, top = profile_kernels(step, top=50)
        if top:
            break
    calls = {name: sum(c for key, _, c in top if name in key)
             for name in ("attn_bwd_kernel", "attn_split_dq_kernel", "attn_split_dkv_kernel")}
    split = A.backward_is_split(n, d)
    want = ({"attn_bwd_kernel": 0, "attn_split_dq_kernel": 1, "attn_split_dkv_kernel": 1}
            if split else
            {"attn_bwd_kernel": 1, "attn_split_dq_kernel": 0, "attn_split_dkv_kernel": 0})
    if calls != want:
        raise AssertionError(f"K2 at N={n}, D={d}: launches by name {calls}, the "
                             f"{'split' if split else 'one-launch'} route expects {want}")
    return {"bwd_route": "split" if split else "one launch", "launches_by_name": calls}


def recipe_k2_routes() -> dict:
    """:func:`k2_route_by_name` at every stage of ``RECIPE_KERNEL_SCRIPTS``'
    nets at each script's batch, ``{"N,H,D": ...}``. Run before any other
    profiler session of the process: late in a long run a session has twice
    recorded none of K2's launches."""
    routes = {}
    for _, script in RECIPE_KERNEL_SCRIPTS:
        _, argv = recipe_argv(script, "", 1)
        batch = int(argv[argv.index("--batch-size") + 1])
        for n, _, h, d in recipe_stages(script):
            routes[f"{n},{h},{d}"] = k2_route_by_name(n, h, d, batch)
    return routes


def check_recipe_kernels(reps: int, routes: dict):
    """K1/K2 (bf16) against their plain versions at the widest heads of each
    stage of ``RECIPE_KERNEL_SCRIPTS``' nets, at each script's batch, with
    K2's route by kernel name from ``routes`` (``recipe_k2_routes``); K3/K4
    at each stage width of the supernets among them. Path ``recipes``; each
    entry names its script."""
    entries = []
    for label, script in RECIPE_KERNEL_SCRIPTS:
        _, argv = recipe_argv(script, "", 1)
        batch = int(argv[argv.index("--batch-size") + 1])
        supernet = argv[argv.index("--model") + 1].endswith("_supernet")
        for i, (n, c, h, d) in enumerate(recipe_stages(script)):
            stage = f"{label} stage {i + 1}"
            for e in check_attention(stage, reps, batch, "recipes", backward=True,
                                     nhd=(n, h, d)):
                e["recipe"] = script
                if e["name"] == "attention_qkv_bwd":
                    e.update(routes[f"{n},{h},{d}"])
                entries.append(e)
            if supernet:
                for e in check_masked_ln(i, reps, batch, "recipes", backward=True, nc=(n, c)):
                    e.update(recipe=script, stage=stage)
                    entries.append(e)
    return entries


def window_inputs(bw: int, n: int, h: int, shift: int, r: int, seed: int):
    """A windowed-attention call's bf16 projection and cotangent, a scale
    near 10 per head, a bias in (0, 16) and, shifted, the region ids."""
    import torch
    from vit_search_torch.models import swin_v2

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(bw, n, 3 * h * 32, device="cuda", generator=gen).bfloat16()
    g = torch.randn(bw, n, h * 32, device="cuda", generator=gen).bfloat16()
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn(h, device="cuda", generator=gen))
    bias = 16 * torch.sigmoid(torch.randn(h, n, n, device="cuda", generator=gen))
    regions = swin_v2.shift_regions(r, int(math.sqrt(n)), shift).cuda() if shift else None
    return qkv, g, scale, bias, regions


def window_work(bw: int, n: int, h: int, d: int, backward: bool):
    """``(bytes, operations)`` of the windowed attention: the projection,
    output and cotangents in bf16, the f32 bias read once (and its gradient
    written once); two N^2 d products forward, five backward."""
    w, table = h * d, 4.0 * h * n * n
    if backward:
        return 2.0 * bw * n * 7 * w + 2 * table, 10.0 * bw * h * n * n * d
    return 2.0 * bw * n * 4 * w + table, 4.0 * bw * h * n * n * d


def check_window_attention(reps: int):
    """The windowed cosine attention (SwinV2) at SwinV2-B's stage shapes:
    out, dqkv, the scale's and the bias's gradients against
    ``window_attention_plain`` with q' and k' rounded as the kernels round them
    (``BF16_TOL``), one counted launch of each record per autograd call,
    and each direction timed beside its bound, the plain version and SDPA
    with a float ``attn_mask`` (the bias plus the shift mask)."""
    import torch
    import torch.nn.functional as F
    from vit_search_torch.ops import window_attention as W

    entries = []
    for i, (bw, n, h, shift, r) in enumerate(SWIN_STAGES):
        qkv, g, scale, bias, regions = window_inputs(bw, n, h, shift, r, 17 + i)
        label = f"SwinV2-B stage {1 + [64, 32, 16, 8].index(r)}" + (" shifted" if shift else "")
        shape = {"B": bw, "N": n, "H": h, "D": 32, "shift": shift, "dtype": "bfloat16"}
        leaves = [qkv.clone().requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        before = (W.WA_FWD.launches, W.WA_BWD.launches)
        out = W.window_attention(leaves[0], leaves[1], leaves[2], regions, h)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        if (W.WA_FWD.launches, W.WA_BWD.launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"window attention {label}: launches not counted once")
        ref_leaves = [qkv.float().requires_grad_(), scale.clone().requires_grad_(),
                      bias.clone().requires_grad_()]
        ref = W.window_attention_plain(*ref_leaves, regions, h, rounded=True)
        ref_grads = torch.autograd.grad(ref, ref_leaves, g.float())
        err_fwd = compare(f"window attention forward {label}", out, ref, BF16_TOL)
        err_bwd = max(compare(f"window attention backward {label} ({what})", a, b, BF16_TOL)
                      for what, a, b in zip(("dqkv", "dscale", "dbias"), grads, ref_grads))
        del out, grads, ref, ref_grads, ref_leaves, leaves
        _, qkvn, rn = W.window_attention_fwd_cuda(qkv, scale, bias, regions, h)
        fwd_ms = graph_ms(W.window_attention_fwd_cuda, (qkv, scale, bias, regions, h), reps)
        bwd_ms = graph_ms(W.window_attention_bwd_cuda, (qkvn, rn, scale, bias, regions, g, h),
                          reps)
        fwd_call_ms = time_ms(lambda: W.window_attention_fwd_cuda(qkv, scale, bias, regions, h),
                              reps)
        bwd_call_ms = time_ms(lambda: W.window_attention_bwd_cuda(qkvn, rn, scale, bias, regions,
                                                                  g, h), reps)
        pleaves = [qkv.float().requires_grad_(), scale.clone().requires_grad_(),
                   bias.clone().requires_grad_()]
        plain_fwd_ms = time_ms(lambda: W.window_attention_plain(qkv, scale, bias, regions, h),
                               reps)
        plain_all_ms = time_ms(lambda: torch.autograd.grad(
            W.window_attention_plain(*pleaves, regions, h), pleaves, g.float()), reps)
        # SDPA over q' and k' with the bias and shift mask as a float mask
        q, k, v = qkv.view(bw, n, 3, h, 32).permute(2, 0, 3, 1, 4)
        mask = bias.bfloat16().expand(bw, h, n, n)
        if regions is not None:
            mask = (bias[None] + W.region_mask(regions)[:, None]).bfloat16().repeat(
                bw // regions.shape[0], 1, 1, 1)
        sq = (F.normalize(q.float(), dim=-1) * scale.view(1, h, 1, 1)).bfloat16()
        sk = F.normalize(k.float(), dim=-1).bfloat16()
        sl = [t.detach().clone().requires_grad_() for t in (sq, sk, v)]

        def sdpa():
            return F.scaled_dot_product_attention(*sl, attn_mask=mask, scale=1.0)

        with torch.no_grad():
            lib_fwd_ms = time_ms(sdpa, reps)
        g_view = g.view(bw, n, h, 32).transpose(1, 2)
        lib_all_ms = time_ms(lambda: torch.autograd.grad(sdpa(), sl, g_view), reps)
        bf = bound(*window_work(bw, n, h, 32, False), PEAK_BF16)
        bb = bound(*window_work(bw, n, h, 32, True), PEAK_BF16)
        tolerance = f"abs <= {BF16_TOL[0]}*max|ref| + {BF16_TOL[1]}*|ref| (bf16 out)"
        common = dict(stage=label, shape=shape, path="swin", tolerance=tolerance)
        entries.append(dict(name="window_attention_fwd", **common, max_abs_err=err_fwd,
                            ms=fwd_ms, call_ms=fwd_call_ms, plain_ms=plain_fwd_ms,
                            bound_ms=bf[0], bound_by=bf[1], library_ms=lib_fwd_ms,
                            library_call="F.scaled_dot_product_attention, float attn_mask"))
        entries.append(dict(name="window_attention_bwd", **common, max_abs_err=err_bwd,
                            ms=bwd_ms, call_ms=bwd_call_ms, plain_ms=plain_all_ms - plain_fwd_ms,
                            bound_ms=bb[0], bound_by=bb[1], library_ms=lib_all_ms - lib_fwd_ms,
                            library_call="F.scaled_dot_product_attention (forward+backward) "
                                         "- forward, float attn_mask"))
        log(f"window attention {label}: fwd {fwd_ms:.4f} ms (bound {bf[0]:.4f}, plain "
            f"{plain_fwd_ms:.3f}, SDPA {lib_fwd_ms:.4f}), bwd {bwd_ms:.4f} ms (bound "
            f"{bb[0]:.4f}, plain {plain_all_ms - plain_fwd_ms:.3f}, SDPA "
            f"{lib_all_ms - lib_fwd_ms:.4f}); max abs err {err_fwd:.3e} / {err_bwd:.3e}")
        del qkv, g, qkvn, rn, mask, sl, pleaves
        torch.cuda.empty_cache()
    return entries


def swin_phase(reps: int) -> dict:
    """The windowed attention at SwinV2-B's stage shapes, then one
    SwinV2-B step at 256 px and 256 images with the recipe's draws:
    launches per step and its rate and peak."""
    import torch
    from vit_search_torch import models, train
    from vit_search_torch.ops import kernels

    entries = check_window_attention(reps)
    model = models.create_model("swinv2_base_window16_256", dtype=torch.bfloat16,
                                device="cuda")
    ocfg = train.OptimConfig(base_lr=5e-4, min_lr=1e-5, warmup_lr=1e-6, warmup_epochs=20,
                             epochs=300, clip_grad=5.0, global_batch_size=1024)
    tcfg = train.TrainConfig(mixup_mode="mixup", erasing_prob=0.25)
    step = train.make_train_step(model, train.make_optimizer(ocfg, model), tcfg,
                                 schedule=train.lr_schedule(ocfg), device="cuda")
    images, labels = synthetic_batch(256, 256, 0)
    for _ in range(WARMUP):
        step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(images, labels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    per = {"window_attention_fwd": 24, "window_attention_bwd": 24,
           "layer_norm_fwd": 53, "layer_norm_bwd": 53, "batch_norm_stats": 0,
           "batch_norm_apply": 0, "batch_norm_bwd": 0}
    check_launches(launches, per, STEPS, "SwinV2-B steps")
    return {"entries": entries, "imgs_per_s": STEPS * 256 / seconds,
            "step_ms": 1e3 * seconds / STEPS, "launches": launches, "per_step": per,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="directory for the full JSON report")
    parser.add_argument("--phase", choices=("all", "swin", "stem"), default="all",
                        help="every phase, or only the SwinV2 or the conv stem's batch norm "
                             "phase (after the build)")
    parser.add_argument("--dist-worker", nargs=4, default=None,
                        metavar=("RANK", "WORLD", "STORE", "OUT"),
                        help="run one rank of the dist phase (the script starts these)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available; nothing was run")
        return 2
    sys.path.insert(0, HERE)
    if args.dist_worker:
        rank, world, store, out = args.dist_worker
        return dist_worker(int(rank), int(world), store, out)
    from vit_search_torch.ops import attention, kernels, masked_layer_norm, stats  # noqa: F401
    from vit_search_torch.ops import batch_norm, window_attention  # noqa: F401
    from vit_search_torch.tools import attn_lab  # noqa: F401

    if sorted(KERNEL_NAMES) != sorted(k.name for k in kernels.KERNELS):
        raise AssertionError(f"launch tables name {sorted(KERNEL_NAMES)}, the port registers "
                             f"{sorted(k.name for k in kernels.KERNELS)}")

    card = card_line()
    print(card, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(reports)} in {build_s:.1f} s")
    report = {"card": card, "kind": kind, "count": count, "build_s": build_s,
              "ptxas": reports}
    report["masked_ln_registers"] = regs = ptxas_summary(reports.get("masked_ln", ""),
                                                         "masked_ln_")
    log("K3/K4 registers (ptxas): " + "; ".join(
        f"{r['kernel']} {r['registers']} regs, spills {r['spill_stores']}/{r['spill_loads']} B"
        for r in regs))

    if args.phase == "swin":
        report["swin"] = sw = swin_phase(REPS)
        print(f"swin: SwinV2-B step {sw['imgs_per_s']:.1f} imgs/s ({sw['step_ms']:.1f} ms/step, "
              f"batch 256 at 256 px) peak memory "
              f"{sw['max_memory_allocated_bytes'] / 2**30:.2f} GiB on {card}; launches a step "
              f"{json.dumps(sw['per_step'])}", flush=True)
        print(json.dumps({"kernels": sw["entries"]}), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke_swin.json"), "w") as f:
                json.dump(report, f, indent=1)
        return 0

    if args.phase == "stem":
        report["stem"] = st = stem_phase(REPS)
        print(f"stem: batch norm launches a train pass "
              f"{json.dumps(st['module']['train_launches'])}, an eval forward "
              f"{json.dumps(st['module']['eval_launches'])} on {card}", flush=True)
        print(json.dumps({"kernels": st["entries"]}), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke_stem.json"), "w") as f:
                json.dump(report, f, indent=1)
        return 0

    # K2's routes at the recipes' shapes by kernel name, in the process's
    # first profiler session
    report["recipe_k2_routes"] = k2_routes = recipe_k2_routes()
    log(f"K2's routes at the recipes' shapes by kernel name: {k2_routes}")

    # the image folder of the loader, cli, dist, study and recipes phases,
    # made on the host while the card runs the kernel checks
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    folder = os.path.join(scratch, "synthfolder")
    maker, folder_s = start_folder(folder)
    atexit.register(stop, maker, scratch)

    entries = []
    for stage in range(len(STAGES)):
        entries += check_kernels(stage, REPS)
        log(f"stage {stage + 1} kernels agree with their plain versions at B = {BATCH} "
            f"and B = {SEARCH_BATCH}")
    entries += check_extra_shapes(REPS)
    log("the attention kernels agree with their plain versions at the 392 px finetune's "
        "stage 1 and at head dim 24")
    entries += check_dense_shapes(REPS)
    log("K1/K2 agree with their plain versions at the searched Tiny net's and the 392 px "
        "finetune's stage shapes")
    for i, (n, c) in enumerate(MEDIUM_STAGES):
        entries += check_layer_norm(f"Medium stage {i + 1}", n, c, REPS, MEDIUM_BATCH, "medium")
    for i, (n, c) in enumerate(MEDIUM_392_STAGES):
        entries += check_layer_norm(f"392px stage {i + 1}", n, c, REPS, MEDIUM_392_BATCH,
                                    "finetune")
    log(f"K3/K4's dense mode agrees with the plain dense layer norm at ViT-ResNAS-Medium's "
        f"stage shapes, B = {MEDIUM_BATCH} at 224 px and B = {MEDIUM_392_BATCH} at 392 px")
    report["stem"] = st = stem_phase(REPS)
    entries += st["entries"]
    for stage in range(len(STAGES)):
        entries += (check_attention(stage, REPS, DIST_BATCH, "dist", backward=True)
                    + check_masked_ln(stage, REPS, DIST_BATCH, "dist", backward=True))
    log(f"K1-K4 agree with their plain versions at a rank's {DIST_BATCH} rows")
    for ln_route in ("fused", "stats"):
        report[f"reference_net_{ln_route}"] = errs = check_reference_net(ln_route)
        log(f"reference net, ln_route={ln_route}: card vs CPU {errs}")
    report["reference_net_bf16"] = errs = check_reference_net("fused", torch.bfloat16)
    print(f"reference net, bfloat16, ln_route=fused: card vs CPU {json.dumps(errs)} "
          f"(tolerance {json.dumps(REF_NET_BF16_TOL)})", flush=True)
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        report[f"reference_net_dense_{name}"] = errs = check_reference_net(
            "fused", dtype, dense=True)
        print(f"reference net, dense, erasing + clipping + EMA, {name}: card vs CPU "
              f"{json.dumps(errs)}", flush=True)
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        report[f"reference_net_distill_{name}"] = errs = check_reference_net(
            "fused", dtype, distill=True)
        print(f"reference net, distill token, mixup + dropout + KD, {name}: card vs CPU "
              f"{json.dumps(errs)}", flush=True)

    report["ops"] = ops = ops_path()
    log(f"op-level API: {ops['passes']} passes, launches K6/K7 "
        f"{ops['launches']['attention_fwd']}/{ops['launches']['attention_bwd']}, K8/K9 "
        f"{ops['launches']['attention_qkv_t_fwd']}/{ops['launches']['attention_qkv_t_bwd']}")
    report["shapes"] = shapes = shapes_path()
    log(f"extra shapes: {len(EXTRA_CALLS)} calls, launches K1/K2 "
        f"{shapes['launches']['attention_qkv_fwd']}/{shapes['launches']['attention_qkv_bwd']}, "
        f"K6/K7 {shapes['launches']['attention_fwd']}/{shapes['launches']['attention_bwd']}, "
        f"K8/K9 {shapes['launches']['attention_qkv_t_fwd']}/"
        f"{shapes['launches']['attention_qkv_t_bwd']}")

    report["swin"] = sw = swin_phase(REPS)
    entries += sw["entries"]
    print(f"swin: SwinV2-B step {sw['imgs_per_s']:.1f} imgs/s ({sw['step_ms']:.1f} ms/step, "
          f"batch 256 at 256 px) peak memory {sw['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
          f"on {card}", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    maker.join()
    if maker.exitcode != 0:
        raise AssertionError(f"make_folder: exit {maker.exitcode}")
    report["folder_s"], report["folder_wait_s"] = folder_s.value, time.perf_counter() - t0
    log(f"folder made in {folder_s.value:.1f} s beside the kernel checks; waited "
        f"{report['folder_wait_s']:.1f} s for it")
    report["train"] = tr = train(STEPS, WARMUP)
    print(f"train: {tr['imgs_per_s']:.1f} imgs/s ({tr['step_ms']:.1f} ms/step, batch "
          f"{BATCH}) peak memory {tr['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
          f"on {card}", flush=True)
    t0 = time.perf_counter()
    report["searched"] = se = searched(STEPS, WARMUP)
    se["seconds"] = time.perf_counter() - t0
    print(f"searched: {se['imgs_per_s']:.1f} imgs/s ({se['step_ms']:.1f} ms/step, batch "
          f"{se['batch']}) peak memory {se['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
          f"on {card}", flush=True)
    t0 = time.perf_counter()
    report["finetune"] = ft = finetune(STEPS, WARMUP)
    ft["seconds"] = time.perf_counter() - t0
    routes = ", ".join(f"stage {i + 1} (N {st['N']}, D {st['D']}) {st['route']}"
                       for i, st in enumerate(ft["k2_routes"]))
    print(f"finetune 392px: {ft['imgs_per_s']:.1f} imgs/s ({ft['step_ms']:.1f} ms/step, "
          f"batch {ft['batch']}) peak memory {ft['max_memory_allocated_bytes'] / 2**30:.2f} "
          f"GiB on {card}; K2 {routes}", flush=True)
    t0 = time.perf_counter()
    report["mixup"] = mx = mixup(STEPS, WARMUP)
    mx["seconds"] = time.perf_counter() - t0
    print(f"mixup: {mx['imgs_per_s']:.1f} imgs/s ({mx['step_ms']:.1f} ms/step, batch "
          f"{mx['batch']}) peak memory {mx['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
          f"on {card}", flush=True)
    t0 = time.perf_counter()
    report["distill"] = ds = distill(STEPS, WARMUP)
    ds["seconds"] = time.perf_counter() - t0
    print(f"distill: {ds['imgs_per_s']:.1f} imgs/s ({ds['step_ms']:.1f} ms/step, batch "
          f"{ds['batch']}) peak memory {ds['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
          f"on {card}; teacher forward {ds['teacher_ms']:.1f} ms per step "
          f"({100 * ds['teacher_share']:.1f}% of the step)", flush=True)
    # the host pipeline and the training CLI on a synthetic image folder, which
    # the dist phase's cli.launch run reads too
    try:
        t0 = time.perf_counter()
        report["loader"] = ld = loader(folder)
        ld["seconds"] = time.perf_counter() - t0
        prof = ld["profiled_step"]
        print(f"loader: {ld['loader_imgs_per_s']:.1f} imgs/s alone over an epoch of "
              f"{ld['batches_per_epoch']} batches (process backend, {ld['host_cores']} "
              f"workers, the first batch after {ld['loader_first_batch_s']:.2f} s; "
              f"os.cpu_count() {ld['host_cpu_count']}, sched_getaffinity "
              f"{ld['host_cores']}; thread backend "
              f"{ld['loader_thread_backend_imgs_per_s']:.1f}); loader-fed train step "
              f"{ld['step_imgs_per_s']:.1f} imgs/s over an epoch of {ld['steps']} steps "
              f"({ld['step_ms']:.1f} ms/step, batch {BATCH}) beside "
              f"{tr['imgs_per_s']:.1f} from device batches; profiled step "
              f"{prof['device_busy_ms']:.1f} ms busy of {prof['wall_ms']:.1f} ms "
              f"({100 * prof['idle_share']:.1f}% idle) on {card}", flush=True)
        t0 = time.perf_counter()
        report["cli"] = cl = cli(folder, scratch)
        cl["wall_s"] = time.perf_counter() - t0
        print(f"cli: super_net/tiny.sh, {cl['train_steps']} steps over {CLI_EPOCHS} epochs "
              f"(SIGTERM in epoch 1, then --resume auto), epoch imgs/s "
              + " / ".join(f"{v:.1f}" for v in cl["epoch_imgs_per_s"])
              + f", --eval acc1 {cl['eval']['acc1']:.3f} on {card}", flush=True)
        log(f"searched phase {se['seconds']:.1f} s, finetune phase {ft['seconds']:.1f} s, "
            f"mixup phase {mx['seconds']:.1f} s, distill phase {ds['seconds']:.1f} s, "
            f"folder {report['folder_s']:.1f} s, loader phase {ld['seconds']:.1f} s, "
            f"cli phase {cl['wall_s']:.1f} s")
        # the search on each masked-LN route, one model on the card at a time;
        # one chunk's logits must agree across the routes
        searches, logits = {}, {}
        for ln_route in ("stats", "fused"):
            searches[ln_route], logits[ln_route] = search(ln_route, card)
        report["search"] = searches
        report["search_logits_stats_vs_fused_max_abs_err"] = compare(
            "search logits, stats vs fused route", logits["stats"], logits["fused"], BF16_TOL)
        del logits
        torch.cuda.empty_cache()   # the card's memory to the dist phase's processes
        t0 = time.perf_counter()
        report["dist"] = dt = dist(folder, scratch, searches["fused"])
        dt["seconds"] = time.perf_counter() - t0
        comm = dt["ranks"][0]["collectives"]
        print(f"dist: {DIST_PROCS} processes time-sharing 1 card over gloo, "
              f"{dt['two_process_imgs_per_s']:.1f} imgs/s in step {DIST_STEPS} of a global "
              f"batch {BATCH} ({DIST_BATCH} rows per rank); losses "
              + " / ".join(f"{v:.6f}" for v in dt["ranks"][0]["losses"]) + " vs one process "
              + " / ".join(f"{v:.6f}" for v in dt["one_process"]["losses"])
              + f"; scores equal to one process over {POPULATION} candidates; rank 0 gather "
              f"{comm['gather_ms']:.1f} ms ({comm['gather_bytes'] / 2**20:.1f} MiB), gradient "
              f"all-reduce {comm['grad_all_reduce_ms']:.1f} ms "
              f"({comm['grad_bytes'] / 2**20:.1f} MiB); cli.launch on NCCL (WORLD_SIZE=1) "
              f"{LAUNCH_STEPS} steps in {dt['launch']['seconds']:.1f} s; phase "
              f"{dt['seconds']:.1f} s on {card}", flush=True)
        torch.cuda.empty_cache()   # the card's memory to the study's and recipes' runs
        # the study's processes run beside the recipes phase: both wait on the
        # host's decode most of the time, and the card holds both
        started = start_study(scratch)
        try:
            report["recipes"] = rc = recipes(folder, scratch)
            report["study"] = st = study(scratch, started)
        finally:
            end_session(started[0])
        sm, stages, gd = st["summary"], st["timing"]["stages"], st["gelu_delta"]
        print(f"study: accuracy_study at {STUDY_SIZE} px beside the recipes phase, done "
              f"{st['wall_s']:.1f} s after its start ("
              + ", ".join(f"{x['stage']} {x['seconds']} s" for x in stages)
              + f"); winner {sm['winner_mac'] / 1e6:.1f}M MACs acc1 "
              f"{sm['winner_final_acc1']:.2f}, random {sm['random_mac'] / 1e6:.1f}M acc1 "
              f"{sm['random_final_acc1']:.2f} (budget {STUDY_BUDGET / 1e6:.1f}M); "
              f"{STUDY_FINETUNE_SIZE} px finetune acc1 "
              f"{sm['finetune_curve'][-1]['test_acc1']:.2f}; gelu_delta max |dlogit| "
              f"{gd['max_abs_dlogit']:.4f}, top-1 agreement {gd['top1_agreement']:.2f}%, K1 "
              f"{st['launches']['attention_qkv_fwd']} launches (2 x "
              f"{st['kernel_attention_blocks']} of the winner's "
              f"{st['winner_attention_blocks']} attention blocks, those at N >= 8) "
              f"on {card}", flush=True)
        slowest = max(rc["scripts"].items(), key=lambda kv: kv[1]["peak_bytes"])
        print(f"recipes: {len(rc['scripts'])} published scripts chained through the port's "
              f"CLIs in {rc['seconds']:.1f} s, each at its own batch"
              + "".join(f", {s} at {b} (cut)" for s, b in RECIPE_BATCH_CUTS.items())
              + f"; the largest peak {slowest[1]['peak_bytes'] / 2**30:.2f} GiB "
              f"({slowest[0]}) on {card}", flush=True)
    finally:
        stop(maker, scratch)
    # the kernels at the recipes' shapes, and one profiled step of the Small
    # supernet from device batches
    t0 = time.perf_counter()
    entries += check_recipe_kernels(REPS, k2_routes)
    log(f"K1-K4 agree with their plain versions at the recipes' shapes "
        f"({time.perf_counter() - t0:.1f} s)")
    report["recipe_profile"] = pr = recipe_profile(RECIPE_KERNEL_SCRIPTS[0][1], 2, 1)
    prof = pr["profiled_step"]
    print(f"{RECIPE_KERNEL_SCRIPTS[0][1]} step from device batches: {pr['imgs_per_s']:.1f} "
          f"imgs/s ({pr['step_ms']:.1f} ms/step, batch {pr['batch']}) peak memory "
          f"{pr['max_memory_allocated_bytes'] / 2**30:.2f} GiB; profiled step "
          f"{prof['device_busy_ms']:.1f} ms busy of {prof['wall_ms']:.1f} ms on {card}",
          flush=True)
    # the lab last: its full-width plain comparisons stay off the train and
    # search lines
    report["lab"] = lab = lab_path()
    ms = {r["name"]: (r["ms"], rs["ms"]) for r, rs in zip(lab["main"], lab["main_split"])}
    log(f"lab: {len(lab['shapes'])} shapes in {lab['seconds']:.1f} s, launches K10/K11/K12a/"
        f"K12b {lab['launches']['lab_fwd_t']}/{lab['launches']['lab_bwd_t']}/"
        f"{lab['launches']['lab_split_dq']}/{lab['launches']['lab_split_dkv']}; ms per call "
        + "; ".join(f"{name}: bwd base {a['bwd base']:.3f} T {a['bwd T']:.3f} split "
                    f"{b['split']:.3f}, fwd base {a['fwd base']:.3f} T {a['fwd T']:.3f}"
                    for name, (a, b) in ms.items()))

    k4_launches(entries, REPS)
    # each kernel entry reports the launches of the path that gives it its shape
    runs = {"train": (tr, PER_STEP),
            "searched": (se, PER_SEARCHED_STEP),
            "finetune": (ft, PER_FINETUNE_STEP),
            # the Medium net's layer norms: the finetune phase trains it
            "medium": (ft, PER_FINETUNE_STEP),
            "distill": (ds, ds["per_step"]),
            "ops": (ops, PER_OPS_PASS),
            "shapes": (shapes, PER_SHAPES_CALL),
            "lab": (lab, PER_LAB_SHAPE),
            "search": (searches["stats"], PER_FORWARD["stats"]),
            "search_fused": (searches["fused"], PER_FORWARD["fused"]),
            "dist": (dt, PER_STEP),
            "swin": (sw, sw["per_step"])}
    by_name = {k.name: k for k in kernels.KERNELS}
    for e in entries:
        k = by_name[e["name"]]
        if e["path"] == "recipes":
            run = rc["scripts"][e["recipe"]]
            per = run["per_step"]
        else:
            run, per = runs[e["path"]]
        e.update(route="cuda", source=k.source, replaces=k.replaces, batch=e["shape"]["B"],
                 launches=run["launches"][e["name"]], launches_per_step=per[e["name"]],
                 kernel_ms=e["ms"])
    report["kernels"] = entries
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
        with open(os.path.join(args.out, "study_summary.json"), "w") as f:
            json.dump(report["study"]["summary"], f, indent=1)
        with open(os.path.join(args.out, "study_RESULTS.md"), "w") as f:
            f.write(report["study"]["markdown"])
    keys = ("name", "stage", "batch", "route", "source", "replaces", "path", "launches",
            "launches_per_step",
            "max_abs_err", "tolerance", "ms", "kernel_ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # the lab's entries also carry their error against K1's / K2's plain function
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys},
                                   **({"err_vs_base": e["err_vs_base"]}
                                      if "err_vs_base" in e else {})} for e in entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
