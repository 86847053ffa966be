"""The port's hand-written CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
when there is none. Shapes are main-path-like (the three ViT-ResNAS-Tiny
stages) at a small batch. Beside the kernels: a small net's train step on the
card against the CPU, and two processes on the one card against one. This
file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The file is also the two processes' worker: ``python tests/test_torch_gpu.py
RANK WORLD STORE OUTDIR`` (with the repository on ``PYTHONPATH``) runs one
rank of a gloo group whose rendezvous is the file STORE.
"""

import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vit_search_torch.ops import attention as A
from vit_search_torch.ops import batch_norm as BN
from vit_search_torch.ops import kernels
from vit_search_torch.ops import masked_layer_norm as M
from vit_search_torch.ops import stats as S
from vit_search_torch.ops.masking import make_channel_mask
from vit_search_torch.tools import attn_lab as L

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = [(257, 256, 6, 32), (65, 512, 12, 48), (17, 1024, 12, 64)]
IDS = ["stage1", "stage2", "stage3"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, tol=2e-2):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    bound = tol * want.abs().max() + tol * want.abs()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= bound).all(), float((got - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kernels_match_plain(cuda, n, c, h, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(4, n, 3 * h * d, device=cuda, generator=gen).to(dtype)
    do = torch.randn(4, n, h * d, device=cuda, generator=gen).to(dtype)
    scale = d ** -0.5
    before = (A.K1.launches, A.K2.launches)
    leaf = qkv.clone().requires_grad_()
    out = A.fused_attention_qkv(leaf, scale, h)
    (dqkv,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    assert (A.K1.launches, A.K2.launches) == (before[0] + 1, before[1] + 1)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _close(out, A.attention_qkv_plain(qkv, scale, h), tol)
    _close(dqkv, A.attention_qkv_bwd_plain(qkv, do, scale, h), tol)


# (N, C, heads, head_dim): small odd lengths, then the stage shapes
LAYOUT_SHAPES = [(9, 0, 2, 16), (33, 0, 3, 8), (65, 0, 2, 128)] + STAGES
LAYOUT_IDS = ["n9h2d16", "n33h3d8", "n65h2d128"] + IDS


def _projection(cuda, n, h, d, dtype, b=4):
    gen = torch.Generator(device=cuda).manual_seed(7 * n + h + d)
    qkv = torch.randn(b, n, 3 * h * d, device=cuda, generator=gen).to(dtype)
    do = torch.randn(b, n, h * d, device=cuda, generator=gen).to(dtype)
    return qkv, do


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", LAYOUT_SHAPES, ids=LAYOUT_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_separate_qkv_kernels_match_plain(cuda, n, c, h, d, dtype):
    """K6/K7 through ``fused_attention_packed``'s autograd function."""
    qkv, do = _projection(cuda, n, h, d, dtype)
    q, k, v = (t.contiguous() for t in qkv.split(h * d, dim=2))
    scale = d ** -0.5
    before = (A.K6.launches, A.K7.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.fused_attention_packed(*leaves, scale, h)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (A.K6.launches, A.K7.launches) == (before[0] + 1, before[1] + 1)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _close(out, A.attention_plain(q, k, v, scale, h), tol)
    for got, want in zip(grads, A.attention_bwd_plain(q, k, v, do, scale, h)):
        _close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", LAYOUT_SHAPES, ids=LAYOUT_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_sequence_major_kernels_match_plain(cuda, n, c, h, d, dtype):
    """K8/K9 through ``fused_attention_qkv_t``'s autograd function."""
    qkv, do = _projection(cuda, n, h, d, dtype)
    qkv_t, do_t = qkv.transpose(0, 1).contiguous(), do.transpose(0, 1).contiguous()
    scale = d ** -0.5
    before = (A.K8.launches, A.K9.launches)
    leaf = qkv_t.clone().requires_grad_()
    out = A.fused_attention_qkv_t(leaf, scale, h)
    (grad,) = torch.autograd.grad(out, leaf, do_t)
    torch.cuda.synchronize()
    assert (A.K8.launches, A.K9.launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == (n, 4, h * d)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _close(out, A.attention_qkv_t_plain(qkv_t, scale, h), tol)
    _close(grad, A.attention_qkv_t_bwd_plain(qkv_t, do_t, scale, h), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
def test_layouts_agree_bit_for_bit(cuda, n, c, h, d):
    """One template serves the three layouts: K6 and K8 give K1's output and
    K7 and K9 K2's cotangent, bit for bit."""
    qkv, do = _projection(cuda, n, h, d, torch.bfloat16)
    scale = d ** -0.5
    out = A.attention_qkv_fwd_cuda(qkv, scale, h)
    dqkv = A.attention_qkv_bwd_cuda(qkv, do, scale, h)
    q, k, v = (t.contiguous() for t in qkv.split(h * d, dim=2))
    assert torch.equal(A.attention_fwd_cuda(q, k, v, scale, h), out)
    assert torch.equal(torch.cat(A.attention_bwd_cuda(q, k, v, do, scale, h), dim=2), dqkv)
    qkv_t, do_t = qkv.transpose(0, 1).contiguous(), do.transpose(0, 1).contiguous()
    assert torch.equal(A.attention_qkv_t_fwd_cuda(qkv_t, scale, h).transpose(0, 1), out)
    assert torch.equal(A.attention_qkv_t_bwd_cuda(qkv_t, do_t, scale, h).transpose(0, 1), dqkv)


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each element's magnitude: the gap to the next bf16."""
    a = x.abs().to(torch.bfloat16)
    return (a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float()


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_packed_forward_within_one_bf16_step_of_plain(cuda, n, c, h, d, dtype):
    """K1 sums in the tensor cores' order, so it no longer gives the plain
    version's bits in bf16. Each output element is within one bf16 step of
    the plain one, plus one bf16 step of each p it sums over: where the two
    sides' f32 p straddle a bf16 rounding point they round it one step
    apart, which moves a near-zero output by more than its own step. In f32
    (the CUDA-core body) it agrees to 1e-4."""
    qkv, _ = _projection(cuda, n, h, d, dtype)
    scale = d ** -0.5
    out = A.attention_qkv_fwd_cuda(qkv, scale, h)
    want = A.attention_qkv_plain(qkv, scale, h)
    if dtype == torch.float32:
        _close(out, want, 1e-4)
        return
    q, k, v = A._split(qkv, h)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    p_steps = torch.einsum("bhnm,bmhd->bnhd", _bf16_step(p), v.abs()).reshape(want.shape)
    err = (out.float() - want.float()).abs()
    assert (err <= _bf16_step(want) + p_steps).all(), float(err.max())


# ragged lengths on both sides of the 16- and 64-row tile edges, D = 8 (the
# head dim padded to 16 in shared memory), and N = 577 at D = 32 (the 336 px
# finetune's stage 1, near the backward's shared-memory limit)
RAGGED = [(8, 2, 32), (15, 2, 16), (16, 2, 16), (17, 2, 64), (63, 2, 48), (64, 2, 48),
          (65, 2, 48), (257, 2, 32), (258, 2, 32), (33, 3, 8), (577, 2, 32)]
RAGGED_IDS = [f"n{n}h{h}d{d}" for n, h, d in RAGGED]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,d", RAGGED, ids=RAGGED_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kernels_take_ragged_lengths(cuda, n, h, d, dtype):
    """K1/K2 against the plain versions, and (bf16) K6-K9 against K1/K2 bit
    for bit, at lengths and widths off the tile edges."""
    qkv, do = _projection(cuda, n, h, d, dtype, b=3)
    scale = d ** -0.5
    out = A.attention_qkv_fwd_cuda(qkv, scale, h)
    dqkv = A.attention_qkv_bwd_cuda(qkv, do, scale, h)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _close(out, A.attention_qkv_plain(qkv, scale, h), tol)
    _close(dqkv, A.attention_qkv_bwd_plain(qkv, do, scale, h), tol)
    if dtype == torch.bfloat16:
        q, k, v = (t.contiguous() for t in qkv.split(h * d, dim=2))
        assert torch.equal(A.attention_fwd_cuda(q, k, v, scale, h), out)
        assert torch.equal(torch.cat(A.attention_bwd_cuda(q, k, v, do, scale, h), dim=2), dqkv)
        qkv_t, do_t = qkv.transpose(0, 1).contiguous(), do.transpose(0, 1).contiguous()
        assert torch.equal(A.attention_qkv_t_fwd_cuda(qkv_t, scale, h).transpose(0, 1), out)
        assert torch.equal(A.attention_qkv_t_bwd_cuda(qkv_t, do_t, scale, h).transpose(0, 1),
                           dqkv)


@pytest.mark.gpu
def test_attention_backward_is_deterministic(cuda):
    """No atomics: the same inputs give the same bits, call after call."""
    qkv, do = _projection(cuda, 257, 6, 32, torch.bfloat16, b=8)
    first = A.attention_qkv_bwd_cuda(qkv, do, 32 ** -0.5, 6)
    for _ in range(3):
        assert torch.equal(A.attention_qkv_bwd_cuda(qkv, do, 32 ** -0.5, 6), first)


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts 2 bytes past 16."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = flat.view(-1)[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
def test_attention_wrappers_raise_on_a_misaligned_operand(cuda):
    """16-byte copies need 16-byte aligned operands: the wrappers refuse an
    unaligned one by name rather than take a slower path."""
    qkv = torch.zeros(2, 17, 3 * 2 * 32, device=cuda, dtype=torch.bfloat16)
    do = torch.zeros(2, 17, 2 * 32, device=cuda, dtype=torch.bfloat16)
    q = do.clone()
    before = (A.K1.launches, A.K2.launches, A.K6.launches, A.K7.launches)
    with pytest.raises(ValueError, match="qkv must be 16-byte aligned"):
        A.attention_qkv_fwd_cuda(_misaligned(qkv), 0.25, 2)
    with pytest.raises(ValueError, match="do must be 16-byte aligned"):
        A.attention_qkv_bwd_cuda(qkv, _misaligned(do), 0.25, 2)
    with pytest.raises(ValueError, match="v must be 16-byte aligned"):
        A.attention_fwd_cuda(q, q, _misaligned(q), 0.25, 2)
    with pytest.raises(ValueError, match="k must be 16-byte aligned"):
        A.attention_bwd_cuda(q, _misaligned(q), q, q, 0.25, 2)
    with pytest.raises(ValueError, match="qkv_t must be 16-byte aligned"):
        A.attention_qkv_t_fwd_cuda(_misaligned(qkv.transpose(0, 1).contiguous()), 0.25, 2)
    assert (A.K1.launches, A.K2.launches, A.K6.launches, A.K7.launches) == before


# the largest N each dtype's kernels take at a head dim (shared memory; PERF.md
# section 7), and where the bf16 backward leaves its one-launch body
MAX_N = {(torch.bfloat16, 32): 1232, (torch.bfloat16, 48): 848, (torch.bfloat16, 64): 656,
         (torch.float32, 32): 842, (torch.float32, 48): 575, (torch.float32, 64): 436}
ONE_LAUNCH_MAX_N = {32: 624, 48: 432, 64: 320}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_shared_memory_limit_is_per_dtype(cuda, d, dtype):
    """Each dtype's backward takes N up to its own limit and the wrapper
    refuses, by name, one token more; the bf16 backward leaves its
    one-launch body for the split route just past ``ONE_LAUNCH_MAX_N``."""
    def call(n):
        qkv = torch.zeros(1, n, 3 * d, device=cuda, dtype=dtype)
        return A.attention_qkv_bwd_cuda(qkv, qkv[..., :d].contiguous(), 0.2, 1)

    top = MAX_N[(dtype, d)]
    assert torch.isfinite(call(top).float()).all()
    with pytest.raises(ValueError, match="shared memory"):
        call(top + 1)
    if dtype == torch.bfloat16:
        one = ONE_LAUNCH_MAX_N[d]
        assert not A.backward_is_split(one, d) and A.backward_is_split(one + 1, d)


# (N, heads, head_dim) of the 392 px finetune's stages (its network_def,
# scripts/vit-sr-nas/finetune/medium_img-size@392.sh), at a few heads
FINETUNE_392 = [(785, 2, 32), (197, 3, 48), (50, 3, 64)]
FINETUNE_IDS = ["n785d32", "n197d48", "n50d64"]


def _all_layouts(qkv, do, scale, h, d):
    """K1/K2, K6/K7 and K8/K9 on one projection: ``{layout: (out, dqkv)}``,
    each in the packed layout."""
    q, k, v = (t.contiguous() for t in qkv.split(h * d, dim=2))
    qkv_t, do_t = qkv.transpose(0, 1).contiguous(), do.transpose(0, 1).contiguous()
    return {"packed": (A.attention_qkv_fwd_cuda(qkv, scale, h),
                       A.attention_qkv_bwd_cuda(qkv, do, scale, h)),
            "separate": (A.attention_fwd_cuda(q, k, v, scale, h),
                         torch.cat(A.attention_bwd_cuda(q, k, v, do, scale, h), dim=2)),
            "seq_major": (A.attention_qkv_t_fwd_cuda(qkv_t, scale, h).transpose(0, 1),
                          A.attention_qkv_t_bwd_cuda(qkv_t, do_t, scale, h).transpose(0, 1))}


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,d", FINETUNE_392, ids=FINETUNE_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kernels_take_the_392px_finetune(cuda, n, h, d, dtype):
    """K1/K2, K6/K7 and K8/K9 against the plain versions at the 392 px
    finetune's stage shapes; the bf16 backward at N = 785 takes the split
    route."""
    qkv, do = _projection(cuda, n, h, d, dtype, b=2)
    scale = d ** -0.5
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    want = (A.attention_qkv_plain(qkv, scale, h), A.attention_qkv_bwd_plain(qkv, do, scale, h))
    for layout, (out, dqkv) in _all_layouts(qkv, do, scale, h, d).items():
        _close(out, want[0], tol)
        _close(dqkv, want[1], tol)
    assert A.backward_is_split(n, d) == (n == 785)


@pytest.mark.gpu
def test_layouts_agree_bit_for_bit_past_the_one_launch_limit(cuda):
    """On the split route (N = 785, D = 32) the three layouts still give one
    another's bits, run after run, and dk and dv are the lab's K12b's."""
    n, h, d = 785, 3, 32
    qkv, do = _projection(cuda, n, h, d, torch.bfloat16, b=3)
    scale = d ** -0.5
    runs = [_all_layouts(qkv, do, scale, h, d) for _ in range(3)]
    first_out, first_grad = runs[0]["packed"]
    for run in runs:
        for out, dqkv in run.values():
            assert torch.equal(out, first_out) and torch.equal(dqkv, first_grad)
    w = h * d
    assert torch.equal(L.split_dkv_cuda(qkv, do, scale, h), first_grad[..., w:])
    assert torch.equal(L.split_dq_cuda(qkv, do, scale, h), first_grad[..., :w])


# head dims off the old (8, 16, 32, 48, 64, 128) list, at ragged lengths
HEAD_DIMS = [(17, 3, 24), (65, 2, 40), (33, 2, 56), (40, 2, 80), (257, 2, 96), (30, 1, 112)]
HEAD_DIM_IDS = [f"n{n}h{h}d{d}" for n, h, d in HEAD_DIMS]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,d", HEAD_DIMS, ids=HEAD_DIM_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kernels_take_every_head_dim(cuda, n, h, d, dtype):
    """Every multiple of 8 up to 128: the kernels of each layout against the
    plain versions, and (bf16) the layouts bit for bit."""
    qkv, do = _projection(cuda, n, h, d, dtype, b=3)
    scale = d ** -0.5
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    want = (A.attention_qkv_plain(qkv, scale, h), A.attention_qkv_bwd_plain(qkv, do, scale, h))
    results = _all_layouts(qkv, do, scale, h, d)
    for out, dqkv in results.values():
        _close(out, want[0], tol)
        _close(dqkv, want[1], tol)
        if dtype == torch.bfloat16:
            assert torch.equal(out, results["packed"][0])
            assert torch.equal(dqkv, results["packed"][1])


@pytest.mark.gpu
def test_model_sends_head_dims_the_kernels_do_not_take_to_plain(cuda):
    """An attention layer with head dim 24 launches K1/K2; one with head dim
    12 runs the plain version on the card and launches nothing."""
    from vit_search_torch.models.layers import Attention

    gen = torch.Generator(device="cpu").manual_seed(0)
    for head_dim, launched in ((24, 1), (12, 0)):
        layer = Attention(48, 48 // head_dim, head_dim, 48, torch.bfloat16, gen).to(cuda)
        x = torch.randn(2, 17, 48, device=cuda, requires_grad=True)
        before = (A.K1.launches, A.K2.launches)
        layer(x).sum().backward()
        torch.cuda.synchronize()
        assert (A.K1.launches - before[0], A.K2.launches - before[1]) == (launched, launched)
        assert torch.isfinite(x.grad).all()


# a supernet of three stages at 112 px, 10 classes: the small net of the card-vs-CPU
# steps
CLI_NET = ((4, 64),
           (1, (64, 4, 16), (64, 128), 1), (1, (64, 4, 16), (64, 128), 1),
           (3, 64, 128),
           (1, (128, 4, 32), (128, 256), 1),
           (3, 128, 256),
           (1, (256, 4, 64), (256, 512), 1),
           (2, 256, 10))
CLI_SPACE = [np.array([64, 48]),
             {"attn": np.array([64, 32]), "mlp": np.array([128, 96]), "layer": None},
             {"attn": np.array([64, 32]), "mlp": np.array([128, 96]), "layer": np.array([64, 0])},
             np.array([128, 96]),
             {"attn": np.array([128, 64]), "mlp": np.array([256, 192]), "layer": None},
             np.array([256, 192]),
             {"attn": np.array([256, 128]), "mlp": np.array([512, 256]), "layer": None},
             None]


# the small net's dense and distill steps: the EMA's decay, the dropout rate,
# and the narrow teacher behind a 112 -> 96 px resize
EMA_DECAY = 0.99996
REF_DROPOUT = 0.1
REF_TEACHER = {"target_size": 96, "widths": (32, 64), "depths": (1, 2), "group_width": 16,
               "stem_width": 16, "num_classes": 10}


def _reference_net(ln_route: str, dtype=torch.float32, dense: bool = False,
                   distill: bool = False) -> dict:
    """A small conv-stem supernet, float32 (or ``dtype``): one train step on
    the card (kernels) against the same on the CPU (plain); the largest
    error of each reading. In bfloat16 the loss, gradient norm and logits
    are held to ``chip_smoke.REF_NET_BF16_TOL``; AdamW's first step moves
    each parameter by about lr whatever its gradient, so only the float32
    run holds the parameters. ``dense`` trains the same net as a searched
    net (no masks, so K3/K4's dense mode on the card) with random erasing,
    gradient clipping and the EMA on, the erasing boxes and noise drawn once
    on the host for both devices; the EMA (decay ``EMA_DECAY``, which damps
    the step's difference) is held to the parameters' float32 tolerance in
    both dtypes. ``distill`` gives the net a distill token and trains it with
    timm Mixup/CutMix (``elem`` mode), dropout ``REF_DROPOUT`` and hard
    distillation from a narrow RegNetY teacher (``REF_TEACHER``: the 112 px
    batch resized to 96 px), the mixup draws and dropout keeps made once on
    the host; the teacher runs in float32 in both dtypes (in bf16 its hard
    labels flip on near-ties, which the loss cannot absorb), its logits held
    card vs CPU within 1e-4 in float32 and, on the same input in bfloat16,
    within the bf16 logits tolerance."""
    from vit_search_torch.data import sample_erasing_draws, sample_mixup_draws
    from vit_search_torch.data.mixup import sample_token_mix_draws
    from vit_search_torch.models import (RegNetYUpsample, SupernetSchedules, build_arch_masks,
                                         create_model)
    from vit_search_torch.train import (OptimConfig, StepDraws, TrainConfig, lr_schedule,
                                        make_optimizer, make_teacher, make_train_step)

    compare = chip_smoke.compare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net, space = CLI_NET, CLI_SPACE
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
        name = "flexible_vit_sr_patch14_224_patch_output"
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
    tol = chip_smoke.REF_NET_BF16_TOL if bf16 else {"logits": (1e-3, 1e-3), "loss": 1e-4,
                                                    "grad_norm": 1e-4}
    second = "dst_logits" if distill else "patch_logits"
    errs = {"cls_logits": compare("ref net cls logits", h1[0], h0[0], tol["logits"]),
            second: compare(f"ref net {second}", h1[1], h0[1], tol["logits"])}
    for what, a, b_ in (("loss", l1, l0), ("grad_norm", g1, g0)):
        assert math.isclose(a, b_, rel_tol=tol[what]), f"ref net {what}: card {a} vs CPU {b_}"
        errs[what] = abs(a - b_)
    if dense:
        assert g0 > clip and g1 > clip, f"gradient norms {g0}, {g1} not clipped at {clip}"
        assert draws.erasing.apply.any(), "no image erased"
        errs["ema_params"] = max(compare(f"ref net EMA {k}", ema1[k], ema0[k], (1e-4, 1e-4),
                                         floor=1e-6) for k in ema0)
    if distill:
        errs["teacher_logits_f32"] = compare("ref net teacher logits", t1["float32"],
                                             t0["float32"], (1e-4, 1e-4))
        errs["teacher_logits_bf16"] = compare("ref net teacher logits, bf16", t1["bfloat16"],
                                              t0["bfloat16"], chip_smoke.REF_NET_BF16_TOL["logits"])
        cutmix = np.asarray(draws.mixup.use_cutmix)
        assert cutmix.any() and not cutmix.all(), "the mixup draws took one branch only"
    if bf16:
        return errs
    # AdamW's first step moves each parameter by about lr whatever the
    # gradient's size, so parameters are held to an absolute floor
    errs["params_after_step"] = max(compare(f"ref net {k}", sd1[k], sd0[k], (1e-4, 1e-4),
                                            floor=1e-6) for k in sd0)
    return errs


@pytest.mark.gpu
@pytest.mark.parametrize("ln_route,dtype", [("fused", torch.float32), ("stats", torch.float32),
                                            ("fused", torch.bfloat16)],
                         ids=["f32-fused", "f32-stats", "bf16-fused"])
def test_reference_net_in_bf16_matches_the_cpu(cuda, ln_route, dtype):
    """The small supernet's train step on the card against the same on the
    CPU (plain versions): in float32 (the attention kernels' CUDA-core
    bodies) on both masked-LN routes (``fused``: K3/K4; ``stats``: K5), the
    parameters after the step too; in bf16 (tensor-core attention) on the
    fused route, at ``chip_smoke.REF_NET_BF16_TOL``."""
    errs = _reference_net(ln_route, dtype)
    print(f"reference net, {ln_route}, {dtype}: card vs CPU {json.dumps(errs)}")
    assert set(errs) >= {"loss", "grad_norm", "cls_logits", "patch_logits"}
    assert ("params_after_step" in errs) == (dtype == torch.float32)


@pytest.mark.gpu
def test_layout_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 17, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k shape"):
        A.attention_fwd_cuda(q, q[:, :9].contiguous(), q, 0.25, 2)
    with pytest.raises(TypeError):
        A.attention_bwd_cuda(q, q, q.float(), q, 0.25, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.attention_fwd_cuda(q, q.cpu(), q, 0.25, 2)
    qkv_t = torch.zeros(17, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do_t shape"):
        A.attention_qkv_t_bwd_cuda(qkv_t, torch.zeros_like(q), 0.25, 2)
    with pytest.raises(ValueError, match="contiguous"):
        A.attention_qkv_t_fwd_cuda(qkv_t.transpose(0, 1), 0.25, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
@pytest.mark.parametrize("shared_mask", [False, True], ids=["per_example", "batch1"])
def test_masked_ln_kernels_match_plain(cuda, n, c, h, d, shared_mask):
    gen = torch.Generator(device=cuda).manual_seed(c)
    b = 4
    counts = torch.as_tensor(np.random.default_rng(c).integers(c // 2, c + 1, 1 if shared_mask
                                                                else b), device=cuda)
    mask = make_channel_mask(counts, c, dtype=torch.bfloat16)
    x = torch.randn(b, n, c, device=cuda, generator=gen).to(torch.bfloat16) * mask
    g = torch.randn(b, n, c, device=cuda, generator=gen).to(torch.bfloat16)
    w = torch.randn(c, device=cuda, generator=gen)
    bias = torch.randn(c, device=cuda, generator=gen)
    y, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
    gx, gw, gb = M.masked_ln_bwd_cuda(x, mask, w, stats, g)
    ref_y, ref_stats = M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6)
    ref_gx, ref_gw, ref_gb = M.masked_ln_bwd_plain(x, mask, w, ref_stats, g)
    _close(y, ref_y)
    _close(stats, ref_stats, 1e-4)
    _close(gx, ref_gx)
    _close(gw, ref_gw, 1e-3)
    _close(gb, ref_gb, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c", [(64, 65, 512), (512, 17, 1024)], ids=["stage2", "stage3"])
def test_gradient_sums_are_deterministic(cuda, b, n, c):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, n, c, device=cuda, generator=gen).to(torch.bfloat16)
    mask = torch.ones(b, 1, c, device=cuda, dtype=torch.bfloat16)
    w, g = torch.randn(c, device=cuda, generator=gen), torch.randn_like(x)
    _, stats = M.masked_ln_fwd_cuda(x, mask, w, w, 1e-6)
    first = M.masked_ln_bwd_cuda(x, mask, w, stats, g)
    for _ in range(3):
        again = M.masked_ln_bwd_cuda(x, mask, w, stats, g)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _offset_copy(x: torch.Tensor, elements: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``elements`` elements into a
    fresh buffer (a view at a row offset, where ``elements`` is a row)."""
    flat = torch.empty(x.numel() + elements, dtype=x.dtype, device=x.device)
    out = flat[elements:].view(x.shape)
    out.copy_(x)
    return out


def _ln_inputs(cuda, b, n, c, dtype, shared_mask, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    counts = torch.as_tensor(np.random.default_rng(seed).integers(
        max(1, c // 4), c + 1, 1 if shared_mask else b), device=cuda)
    mask = make_channel_mask(counts, c, dtype=dtype)
    x = (torch.randn(b, n, c, device=cuda, generator=gen) * 2 + 0.5).to(dtype) * mask
    g = torch.randn(b, n, c, device=cuda, generator=gen).to(dtype)
    w = torch.randn(c, device=cuda, generator=gen)
    bias = torch.randn(c, device=cuda, generator=gen)
    return x, mask, w, bias, g


def _ln_against_plain(x, mask, w, bias, g):
    y, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
    gx, gw, gb = M.masked_ln_bwd_cuda(x, mask, w, stats, g)
    ref_y, ref_stats = M.masked_ln_fwd_plain(x, mask, w, bias, 1e-6)
    ref_gx, ref_gw, ref_gb = M.masked_ln_bwd_plain(x, mask, w, ref_stats, g)
    _close(y, ref_y)
    _close(stats, ref_stats, 1e-4)
    _close(gx, ref_gx)
    _close(gw, ref_gw, 1e-3)
    _close(gb, ref_gb, 1e-3)


# (B, N, C, dtype, shared mask, path): the stage shapes at the train batch,
# stage 3 at a scoring forward's; fewer rows than SMs; rows not a multiple of
# the tile; the narrowest and widest C; float32; the batch-1 mask; "tiled" or
# "general" is the path the launch plan must pick
LN_CASES = [(512, 257, 256, torch.bfloat16, False, "tiled"),
            (512, 65, 512, torch.bfloat16, False, "tiled"),
            (512, 17, 1024, torch.bfloat16, False, "tiled"),
            (2048, 17, 1024, torch.bfloat16, False, "tiled"),
            (3, 17, 256, torch.bfloat16, False, "tiled"),
            (7, 33, 512, torch.bfloat16, False, "tiled"),
            (5, 3, 4, torch.bfloat16, False, "general"),
            (9, 11, 12, torch.bfloat16, False, "general"),
            (6, 13, 100, torch.bfloat16, True, "general"),
            (6, 13, 100, torch.float32, False, "tiled"),
            (16, 9, 2048, torch.bfloat16, False, "tiled"),
            (16, 9, 2048, torch.float32, False, "tiled"),
            (64, 65, 512, torch.float32, True, "tiled"),
            (64, 17, 1024, torch.bfloat16, True, "tiled"),
            (40, 1, 8, torch.bfloat16, False, "tiled")]
LN_IDS = ["stage1", "stage2", "stage3", "stage3_b2048", "rows_lt_sms", "ragged", "c4",
          "c12", "c100_batch1", "c100_f32", "c2048", "c2048_f32", "stage2_f32_batch1",
          "stage3_batch1", "n1"]


# (N, heads, head_dim) at each stage's widest heads of the published recipes
# first run on the card in the recipes phase: the Small supernet, the
# sr_tiny_666 supernet, the reference net, the 280 px Medium finetune
RECIPE_ATTENTION = [(257, 8, 32), (65, 16, 48), (17, 16, 64), (257, 4, 64), (65, 8, 64),
                    (17, 12, 64), (257, 3, 64), (65, 6, 64), (401, 8, 32), (101, 16, 48),
                    (26, 16, 64)]
RECIPE_IDS = [f"n{n}h{h}d{d}" for n, h, d in RECIPE_ATTENTION]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,d", RECIPE_ATTENTION, ids=RECIPE_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kernels_take_the_recipes_shapes(cuda, n, h, d, dtype):
    """K1/K2 through the model's autograd entry point at the recipes'
    shapes, one launch each; the bf16 backward on its one-launch body (N <=
    624 at D = 32, and N = 257 at D = 64 fits)."""
    qkv, do = _projection(cuda, n, h, d, dtype, b=2)
    scale = d ** -0.5
    before = (A.K1.launches, A.K2.launches)
    leaf = qkv.clone().requires_grad_()
    out = A.fused_attention_qkv(leaf, scale, h)
    (dqkv,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    assert (A.K1.launches, A.K2.launches) == (before[0] + 1, before[1] + 1)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _close(out, A.attention_qkv_plain(qkv, scale, h), tol)
    _close(dqkv, A.attention_qkv_bwd_plain(qkv, do, scale, h), tol)
    assert not A.backward_is_split(n, d)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c", [(8, 257, 320), (8, 65, 640), (8, 17, 1280),
                                   (1024, 17, 1280)], ids=["c320", "c640", "c1280", "c1280_b1024"])
def test_masked_ln_kernels_take_the_small_supernets_widths(cuda, b, n, c):
    """K3/K4 at the Small supernet's stage widths, which are not on the
    tiled path's ladder of 8 / 16 / 32 lanes at C = 256 / 512 / 1024."""
    x, mask, w, bias, g = _ln_inputs(cuda, b, n, c, torch.bfloat16, False, seed=b + n + c)
    plan = M.launch_plan(b * n, n, c, x.element_size(), False, True, kernels.num_sms(x), True)
    assert plan.tile_rows > 0
    _ln_against_plain(x, mask, w, bias, g)


@pytest.mark.gpu
def test_global_norm_on_the_card_matches_float64(cuda):
    """The train step's gradient norm over gradients of the Small
    supernet's largest shapes, on the card."""
    from vit_search_torch.train import global_norm

    gen = torch.Generator(device=cuda).manual_seed(0)
    grads = [torch.randn(shape, device=cuda, generator=gen) * 0.01 + 0.003
             for shape in ((3840, 1280), (1280, 3840), (1000, 1280))]
    exact = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    got = global_norm(grads)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert abs(float(got) - exact) <= 1e-6 * exact


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,dtype,shared_mask,path", LN_CASES, ids=LN_IDS)
def test_masked_ln_kernels_take_every_shape(cuda, b, n, c, dtype, shared_mask, path):
    x, mask, w, bias, g = _ln_inputs(cuda, b, n, c, dtype, shared_mask, seed=b + n + c)
    plan = M.launch_plan(b * n, n, c, x.element_size(), shared_mask, True,
                         kernels.num_sms(x), True)
    assert (plan.tile_rows > 0) == (path == "tiled")
    before = (M.K3.launches, M.K4.launches)
    _ln_against_plain(x, mask, w, bias, g)
    assert (M.K3.launches, M.K4.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("c,offset", [(12, 12), (256, 4), (1024, 1024)],
                         ids=["c12_odd_row", "c256_8_bytes", "c1024_odd_row"])
def test_masked_ln_kernels_take_a_view_off_16_bytes(cuda, c, offset):
    """A contiguous view at an offset: off a 16-byte boundary it takes the
    general path (C = 12 at an odd row; 4 bf16 elements in), at one it takes
    the tiled path (an odd row of C = 1024); either way the plain function."""
    x, mask, w, bias, g = _ln_inputs(cuda, 6, 17, c, torch.bfloat16, False, seed=c)
    x, g, mask = _offset_copy(x, offset), _offset_copy(g, offset), _offset_copy(mask, offset)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, mask))
    assert aligned == (c == 1024)
    _ln_against_plain(x, mask, w, bias, g)


@pytest.mark.gpu
def test_masked_ln_kernels_are_captured_in_a_cuda_graph(cuda):
    x, mask, w, bias, g = _ln_inputs(cuda, 64, 17, 1024, torch.bfloat16, False, seed=3)
    y, stats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
    want = (y, stats) + M.masked_ln_bwd_cuda(x, mask, w, stats, g)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy, gstats = M.masked_ln_fwd_cuda(x, mask, w, bias, 1e-6)
        got = (gy, gstats) + M.masked_ln_bwd_cuda(x, mask, w, gstats, g)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# (B, N, C): ViT-ResNAS-Medium's dense layer norms at 224 and 392 px, at a
# small batch
MEDIUM_LN = [(4, 257, 240), (4, 65, 640), (4, 17, 880), (2, 785, 240), (2, 197, 640),
             (2, 50, 880)]
MEDIUM_LN_IDS = ["224_stage1", "224_stage2", "224_stage3", "392_stage1", "392_stage2",
                 "392_stage3"]


def _dense_inputs(cuda, b, n, c, dtype, seed, mean=0.5, spread=2.0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(b, n, c, device=cuda, generator=gen) * spread + mean).to(dtype)
    g = torch.randn(b, n, c, device=cuda, generator=gen).to(dtype)
    w = torch.randn(c, device=cuda, generator=gen)
    bias = torch.randn(c, device=cuda, generator=gen)
    return x, w, bias, g


def _dense_against_plain(x, w, bias, g):
    """The dense layer norm through the op (K3/K4's dense mode) against the
    plain dense function in float32, at the masked route's tolerances; the
    dense records count one launch each, the masked ones none."""
    before = (M.LN_FWD.launches, M.LN_BWD.launches, M.K3.launches, M.K4.launches)
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
    y = M.masked_layer_norm(*leaves, None)
    grads = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert (M.LN_FWD.launches, M.LN_BWD.launches, M.K3.launches, M.K4.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    assert y.dtype == x.dtype and grads[0].dtype == x.dtype
    assert grads[1].dtype == grads[2].dtype == torch.float32
    ref = [t.detach().float().requires_grad_() for t in (x, w, bias)]
    ref_y = M.layer_norm_plain(*ref, 1e-6)
    ref_grads = torch.autograd.grad(ref_y, ref, g.float())
    _close(y, ref_y)
    _close(grads[0], ref_grads[0])
    _close(grads[1], ref_grads[1], 1e-3)
    _close(grads[2], ref_grads[2], 1e-3)


def _close_stats(stats, x):
    """K3's ``(mu, inv_std)`` against each row's in float32, the variance from
    two passes; mu and inv_std each at 1e-4 of their own size."""
    xf = x.float()
    mu = xf.mean(-1)
    _close(stats[..., 0], mu, 1e-4)
    _close(stats[..., 1], torch.rsqrt((xf - mu[..., None]).square().mean(-1) + 1e-6), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c", MEDIUM_LN, ids=MEDIUM_LN_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_dense_layer_norm_kernels_match_plain(cuda, b, n, c, dtype):
    x, w, bias, g = _dense_inputs(cuda, b, n, c, dtype, seed=b + n + c)
    plan = M.launch_plan(b * n, n, c, x.element_size(), False, True, kernels.num_sms(x), True,
                         dense=True)
    assert plan.tile_rows > 0 and plan.mask_rows == 0
    _dense_against_plain(x, w, bias, g)
    _, stats = M.layer_norm_fwd_cuda(x, w, bias, 1e-6)
    _close_stats(stats, x)


@pytest.mark.gpu
@pytest.mark.parametrize("c,offset,dtype", [(256, 4, torch.bfloat16), (100, 0, torch.bfloat16),
                                            (12, 0, torch.bfloat16), (880, 4, torch.bfloat16)],
                         ids=["bf16_c256_8_bytes", "bf16_c100", "bf16_c12", "bf16_c880_8_bytes"])
def test_dense_layer_norm_kernels_take_the_general_path(cuda, c, offset, dtype):
    """A bf16 view off a 16-byte boundary, and a bf16 row that is not whole
    16-byte vectors, take the general path (a warp per row, the row in
    registers). A float32 row on a 4-element boundary is always on 16
    bytes, so float32 takes the tiled path."""
    x, w, bias, g = _dense_inputs(cuda, 6, 17, c, dtype, seed=c)
    if offset:
        x, g = _offset_copy(x, offset), _offset_copy(g, offset)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g))
    plan = M.launch_plan(6 * 17, 17, c, x.element_size(), False, aligned, kernels.num_sms(x),
                         True, dense=True)
    assert plan.tile_rows == 0
    _dense_against_plain(x, w, bias, g)
    _, stats = M.layer_norm_fwd_cuda(x, w, bias, 1e-6)
    _close_stats(stats, x)


@pytest.mark.gpu
@pytest.mark.parametrize("c,offset", [(640, 0), (100, 0), (256, 4)],
                         ids=["tiled", "general_c100", "general_8_bytes"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_dense_layer_norm_takes_two_passes_over_a_row(cuda, c, offset, dtype):
    """Rows whose mean is 100 times their spread: the kernels' variance,
    mean((x - mu)^2), holds inv_std to 1e-4 of the plain function's, where
    mean(x^2) - mu^2 in float32 would not."""
    x, w, bias, g = _dense_inputs(cuda, 8, 65, c, dtype, seed=7, mean=100.0, spread=1.0)
    if offset:
        x, g = _offset_copy(x, offset), _offset_copy(g, offset)
    _, stats = M.layer_norm_fwd_cuda(x, w, bias, 1e-6)
    _close_stats(stats, x)
    _dense_against_plain(x, w, bias, g)


@pytest.mark.gpu
def test_dense_layer_norm_kernels_are_captured_in_a_cuda_graph(cuda):
    x, w, bias, g = _dense_inputs(cuda, 64, 65, 640, torch.bfloat16, seed=3)
    y, stats = M.layer_norm_fwd_cuda(x, w, bias, 1e-6)
    want = (y, stats) + M.layer_norm_bwd_cuda(x, w, stats, g)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy, gstats = M.layer_norm_fwd_cuda(x, w, bias, 1e-6)
        got = (gy, gstats) + M.layer_norm_bwd_cuda(x, w, gstats, g)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,offset,error,match", [
    ((2, 5, 6), torch.bfloat16, 0, ValueError, "C % 4"),
    ((2, 5, 2052), torch.bfloat16, 0, ValueError, "C <= 2048"),
    ((2, 5, 64), torch.float16, 0, TypeError, "dtype"),
    ((10, 64), torch.bfloat16, 0, ValueError, "3 dims"),
    ((2, 5, 7, 64), torch.bfloat16, 0, ValueError, "3 dims"),
    ((2, 5, 64), torch.bfloat16, 2, ValueError, "aligned")],
    ids=["c6", "c2052", "float16", "2d", "4d", "offset_4_bytes"])
def test_dense_layer_norm_raises_on_what_the_kernels_refuse(cuda, shape, dtype, offset, error,
                                                            match):
    """On the card the dense layer norm goes through K3/K4 or raises: C % 4
    != 0, C past the widest, float16, a tensor that is not 3-D and a view off
    a 4-element boundary launch nothing and fall back to nothing."""
    c = shape[-1]
    flat = torch.randn(int(np.prod(shape)) + offset, device=cuda).to(dtype)
    x = flat[offset:].view(shape)
    w, bias = torch.ones(c, device=cuda), torch.zeros(c, device=cuda)
    before = (M.LN_FWD.launches, M.LN_BWD.launches)
    with pytest.raises(error, match=match):
        M.masked_layer_norm(x, w, bias, None)
    assert (M.LN_FWD.launches, M.LN_BWD.launches) == before


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    qkv = torch.zeros(2, 17, 3 * 2 * 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        A.attention_qkv_fwd_cuda(qkv, 0.2, 4)                  # d = 12
    with pytest.raises(ValueError, match="head_dim"):
        A.attention_qkv_bwd_cuda(torch.zeros(2, 17, 3 * 136, device=cuda,
                                             dtype=torch.bfloat16),
                                 torch.zeros(2, 17, 136, device=cuda, dtype=torch.bfloat16),
                                 0.1, 1)                       # d = 136
    with pytest.raises(TypeError):
        A.attention_qkv_fwd_cuda(qkv.half(), 0.2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        A.attention_qkv_fwd_cuda(qkv.transpose(0, 1), 0.2, 3)
    x = torch.zeros(2, 5, 6, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 4"):
        M.masked_ln_fwd_cuda(x, torch.ones(2, 1, 6, device=cuda, dtype=torch.bfloat16),
                             torch.ones(6, device=cuda), torch.zeros(6, device=cuda), 1e-6)
    x = torch.zeros(2, 5, 2052, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C <= 2048"):
        M.masked_ln_fwd_cuda(x, torch.ones(2, 1, 2052, device=cuda, dtype=torch.bfloat16),
                             torch.ones(2052, device=cuda), torch.zeros(2052, device=cuda),
                             1e-6)
    x = _offset_copy(torch.zeros(2, 5, 8, device=cuda, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="x must be 8-byte aligned"):
        M.masked_ln_fwd_cuda(x, torch.ones(2, 1, 8, device=cuda, dtype=torch.bfloat16),
                             torch.ones(8, device=cuda), torch.zeros(8, device=cuda), 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_row_stats_kernel_matches_plain(cuda, n, c, h, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + c)
    x = (torch.randn(4, n, c, device=cuda, generator=gen) * 2 + 0.5).to(dtype)
    before = S.K5.launches
    s1, s2 = S.row_sum_sumsq_cuda(x)
    torch.cuda.synchronize()
    assert S.K5.launches == before + 1
    ref1, ref2 = S.row_sum_sumsq_plain(x)
    _close(s1, ref1, 1e-4)
    _close(s2, ref2, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 5, 100, 1000, 4096, 4100])
def test_row_stats_kernel_takes_any_width(cuda, c):
    """Ragged widths take the element-wise loads; wide rows loop per lane."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(3, 7, c, device=cuda, generator=gen).to(torch.bfloat16)
    for got, want in zip(S.row_sum_sumsq_cuda(x), S.row_sum_sumsq_plain(x)):
        _close(got, want, 1e-4)


@pytest.mark.gpu
def test_row_stats_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(512, 65, 512, device=cuda, generator=gen).to(torch.bfloat16)
    first = S.row_sum_sumsq_cuda(x)
    for _ in range(3):
        again = S.row_sum_sumsq_cuda(x)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
def test_stats_route_matches_fused_route(cuda, n, c, h, d):
    """Masked LN from K5's sums (plus plain torch) against K3, and the
    gradients through K5's elementwise backward against K4."""
    gen = torch.Generator(device=cuda).manual_seed(c + 1)
    counts = torch.as_tensor(np.random.default_rng(c).integers(c // 2, c + 1, 4), device=cuda)
    mask = make_channel_mask(counts, c, dtype=torch.bfloat16)
    x = torch.randn(4, n, c, device=cuda, generator=gen).to(torch.bfloat16) * mask
    g = torch.randn(4, n, c, device=cuda, generator=gen).to(torch.bfloat16)
    w, bias = torch.randn(c, device=cuda, generator=gen), torch.randn(c, device=cuda,
                                                                      generator=gen)
    out = {}
    for route in ("fused", "stats"):
        leaf = x.clone().requires_grad_()
        y = M.masked_layer_norm(leaf, w, bias, mask, route=route)
        (gx,) = torch.autograd.grad(y, leaf, g)
        out[route] = (y, gx)
    _close(out["stats"][0], out["fused"][0])
    _close(out["stats"][1], out["fused"][1])


@pytest.mark.gpu
def test_evaluator_refuses_cpu_tensors(cuda):
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.search import BatchedSupernetEvaluator

    net = ((0, 16), (1, (16, 2, 8), (16, 32), 1), (2, 16, 4))
    space = [np.array([16, 8]), {"attn": np.array([16]), "mlp": np.array([32]),
                                 "layer": None}, None]
    model = create_model("flexible_vit_sr_patch14_224", network_def=net, img_size=28,
                         ln_route="stats")
    images = torch.zeros(2, 28, 28, 3, dtype=torch.uint8)
    labels = torch.tensor([0, 1])
    ev = BatchedSupernetEvaluator(model, SupernetSchedules(net, space, 1, 0),
                                  [(images, labels)])
    with pytest.raises(ValueError, match="the step runs on cuda"):
        ev.score([net])
    ev.loader = [(images.to(cuda), labels.to(cuda))]
    (score,) = ev.score([net])
    assert 0.0 <= score <= 100.0


@pytest.mark.gpu
def test_build_is_cached_by_source_hash(cuda):
    kernels.build_all()
    assert kernels.build_all() == {}
    for name in kernels.SOURCES:
        assert kernels._lib_path(name).exists()


# the lab's kernels: the stage shapes, the lab's own even lengths, ragged
# tails (N below one 32-query tile, one past it) and the widest head
LAB_SHAPES = STAGES + [(258, 0, 6, 32), (9, 0, 2, 16), (33, 0, 3, 8), (65, 0, 2, 128)]
LAB_IDS = IDS + ["n258h6d32", "n9h2d16", "n33h3d8", "n65h2d128"]
LAB_KERNELS = {"K10": (L.fwd_T_cuda, L.fwd_T_plain, L.K10, False),
               "K11": (L.bwd_T_cuda, L.bwd_T_plain, L.K11, True),
               "K12a": (L.split_dq_cuda, L.split_dq_plain, L.K12A, True),
               "K12b": (L.split_dkv_cuda, L.split_dkv_plain, L.K12B, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(LAB_KERNELS))
@pytest.mark.parametrize("n,c,h,d", LAB_SHAPES, ids=LAB_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_lab_kernels_match_plain(cuda, kernel, n, c, h, d, dtype):
    cuda_fn, plain, record, with_do = LAB_KERNELS[kernel]
    qkv, do = _projection(cuda, n, h, d, dtype)
    args = (qkv, do) if with_do else (qkv,)
    before = record.launches
    got = cuda_fn(*args, d ** -0.5, h)
    torch.cuda.synchronize()
    assert record.launches == before + 1
    _close(got, plain(*args, d ** -0.5, h), 2e-2 if dtype == torch.bfloat16 else 1e-4)


# the split's kernels alone: ragged lengths, and N = 785 (bf16 only: the
# CUDA-core f32 bodies hold all four operands and stop near N = 420 at D = 32)
SPLIT_SHAPES = [(17, 2, 64), (100, 3, 48), (785, 2, 32)]
SPLIT_IDS = [f"n{n}h{h}d{d}" for n, h, d in SPLIT_SHAPES]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K12a", "K12b"])
@pytest.mark.parametrize("n,h,d", SPLIT_SHAPES, ids=SPLIT_IDS)
def test_lab_split_kernels_take_ragged_lengths(cuda, kernel, n, h, d):
    cuda_fn, plain, record, _ = LAB_KERNELS[kernel]
    qkv, do = _projection(cuda, n, h, d, torch.bfloat16, b=2)
    before = record.launches
    got = cuda_fn(qkv, do, d ** -0.5, h)
    torch.cuda.synchronize()
    assert record.launches == before + 1
    _close(got, plain(qkv, do, d ** -0.5, h))


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES + [(258, 0, 6, 32)], ids=IDS + ["n258h6d32"])
def test_lab_split_dkv_gives_k2_bits(cuda, n, c, h, d):
    """K12b walks the query tiles in K2's order with K2's arithmetic, so its
    dk and dv are the one-launch K2's bits; K12a's dq sums the key blocks in
    another order and is held to the tolerance only."""
    qkv, do = _projection(cuda, n, h, d, torch.bfloat16)
    scale, w = d ** -0.5, h * d
    want = A.attention_qkv_bwd_cuda(qkv, do, scale, h)
    assert not A.backward_is_split(n, d)
    assert torch.equal(L.split_dkv_cuda(qkv, do, scale, h), want[..., w:])
    _close(L.split_dq_cuda(qkv, do, scale, h), want[..., :w])


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
def test_lab_backwards_agree_with_k2(cuda, n, c, h, d):
    """K11 and the concatenated K12a + K12b compute K2's packed cotangent;
    the split launches each of its kernels once."""
    qkv, do = _projection(cuda, n, h, d, torch.bfloat16)
    scale = d ** -0.5
    want = A.attention_qkv_bwd_cuda(qkv, do, scale, h)
    before = (L.K12A.launches, L.K12B.launches)
    split = L.split_cuda(qkv, do, scale, h)
    assert (L.K12A.launches, L.K12B.launches) == (before[0] + 1, before[1] + 1)
    _close(L.bwd_T_cuda(qkv, do, scale, h), want)
    _close(split, want)


@pytest.mark.gpu
def test_lab_fwd_T_is_not_k1_in_bf16(cuda):
    """K10 keeps p in f32: in bf16 it differs from K1, in f32 it agrees."""
    qkv, _ = _projection(cuda, 65, 12, 48, torch.bfloat16)
    assert not torch.equal(L.fwd_T_cuda(qkv, 48 ** -0.5, 12), A.attention_qkv_fwd_cuda(
        qkv, 48 ** -0.5, 12))
    x = qkv.float()
    _close(L.fwd_T_cuda(x, 48 ** -0.5, 12), A.attention_qkv_fwd_cuda(x, 48 ** -0.5, 12), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,d", STAGES, ids=IDS)
def test_lab_bf16_kernels_are_closer_to_f32_than_k1_k2(cuda, n, c, h, d):
    """In bf16, K10 and K11 take p and ds as hi/lo pairs: their mean error
    against the lab's f32 function (the plain versions on f32 inputs) is
    strictly below that of K1's rounding (p as one bf16 operand) and of K2
    on the card."""
    qkv, do = _projection(cuda, n, h, d, torch.bfloat16)
    scale = d ** -0.5

    def mean_err(got, want):
        return float((got.float() - want).abs().mean())

    fwd = L.fwd_T_plain(qkv.float(), scale, h)
    assert (mean_err(L.fwd_T_cuda(qkv, scale, h), fwd)
            < mean_err(A.attention_qkv_plain(qkv, scale, h), fwd))
    bwd = L.bwd_T_plain(qkv.float(), do.float(), scale, h)
    assert (mean_err(L.bwd_T_cuda(qkv, do, scale, h), bwd)
            < mean_err(A.attention_qkv_bwd_cuda(qkv, do, scale, h), bwd))


# the largest N each lab kernel takes at D = 32 by dtype (shared memory; bf16:
# the tensor-core bodies of K1 and K2's one launch; PERF.md section 7)
LAB_MAX_N = {("K10", torch.bfloat16): 1376, ("K10", torch.float32): 587,
             ("K11", torch.bfloat16): 624, ("K11", torch.float32): 283}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K10", "K11"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_lab_kernels_take_their_largest_n(cuda, kernel, dtype):
    """K10 and K11 against their plain versions at the largest N their
    shared memory holds at D = 32, and refused by name one token past it
    (K11 stays one launch: it takes no split route)."""
    cuda_fn, plain, record, with_do = LAB_KERNELS[kernel]
    top = LAB_MAX_N[(kernel, dtype)]

    def args(n):
        qkv, do = _projection(cuda, n, 2, 32, dtype, b=1)
        return (qkv, do, 32 ** -0.5, 2) if with_do else (qkv, 32 ** -0.5, 2)

    before = record.launches
    got = cuda_fn(*args(top))
    torch.cuda.synchronize()
    assert record.launches == before + 1
    _close(got, plain(*args(top)), 2e-2 if dtype == torch.bfloat16 else 1e-4)
    with pytest.raises(ValueError, match=f"{record.name} needs .* shared memory"):
        cuda_fn(*args(top + 1))
    assert record.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(LAB_KERNELS))
def test_lab_wrappers_raise_on_what_the_kernels_do_not_take(cuda, kernel):
    cuda_fn, _, record, with_do = LAB_KERNELS[kernel]
    qkv = torch.zeros(2, 17, 3 * 2 * 24, device=cuda, dtype=torch.bfloat16)
    do = torch.zeros(2, 17, 2 * 24, device=cuda, dtype=torch.bfloat16)
    before = record.launches
    with pytest.raises(ValueError, match="head_dim"):                     # d = 24
        cuda_fn(*((qkv, do) if with_do else (qkv,)), 0.2, 2)
    with pytest.raises(TypeError):
        cuda_fn(*((qkv.half(), do.half()) if with_do else (qkv.half(),)), 0.2, 3)
    if with_do:
        with pytest.raises(TypeError):
            cuda_fn(qkv, do.float(), 0.2, 3)
        with pytest.raises(ValueError, match="do shape"):
            cuda_fn(qkv, do[:, :9].contiguous(), 0.2, 3)
    with pytest.raises(ValueError, match="shared memory"):                # N = 2048, d = 128
        long = torch.zeros(1, 2048, 3 * 128, device=cuda, dtype=torch.bfloat16)
        cuda_fn(*((long, long[..., :128].contiguous()) if with_do else (long,)), 0.1, 1)
    assert record.launches == before


@pytest.mark.gpu
def test_lab_main_runs_on_the_card(cuda, capsys):
    """The lab's entry points at small shapes: every line printed, errors
    within the bf16 tolerance, and each kernel launched as often as the run
    calls it (one numerics call, one warm-up and three timed runs of iters)."""
    shapes = [("a", 4, 33, 2, 32), ("b", 4, 18, 3, 64)]
    iters = 2
    kernels.reset_launches()
    records = L.main(shapes, iters=iters)
    split = L.main_split(shapes, iters=iters)
    torch.cuda.synchronize()
    calls = len(shapes) * (2 + 3 * iters)
    assert (A.K1.launches, A.K2.launches) == (calls, 2 * calls)
    assert (L.K10.launches, L.K11.launches, L.K12A.launches, L.K12B.launches) == (calls,) * 4
    out = capsys.readouterr().out
    assert out.count("bwd_err=") == len(shapes) and out.count(" err=") == len(shapes)
    for r in records:
        assert r["bwd_err"] <= 2e-2 * r["bwd_ref_max"] and r["fwd_err"] <= 2e-2 * r["fwd_ref_max"]
    for r in split:
        assert r["err"] <= 2e-2 * r["ref_max"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_step_with_erasing_clipping_and_ema_matches_the_cpu(cuda, dtype):
    """The small net trained as a searched net (no masks), one step with
    random erasing, gradient clipping and the EMA, on the card against the
    CPU with the same draws, at chip_smoke's tolerances."""
    errs = _reference_net("fused", dtype, dense=True)
    assert set(errs) >= {"loss", "grad_norm", "cls_logits", "patch_logits", "ema_params"}


@pytest.mark.gpu
def test_finetune_392_step_takes_the_split_route(cuda):
    """One bf16 step of ViT-ResNAS-Medium at 392 px, batch 2: K1/K2 launch
    once per attention layer (20), and stage 1 (N = 785, D = 32, 7 blocks)
    runs K2's split route, a dq and a dk/dv launch per call, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from vit_search_torch.arch import presets
    from vit_search_torch.models import create_model
    from vit_search_torch.train import (OptimConfig, TrainConfig, make_optimizer,
                                        make_train_step)

    model = create_model("flexible_vit_sr_patch14_392_patch_output",
                         network_def=presets.VIT_RESNAS_MEDIUM, dtype=torch.bfloat16,
                         drop_path_rate=0.75, gelu="tanh")
    step = make_train_step(model, make_optimizer(OptimConfig(base_lr=5e-6), model),
                           TrainConfig(mixup_mode="token", patch_len=7, ema_decay=0.99996,
                                       erasing_prob=0.25))
    gen = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randint(0, 256, (2, 392, 392, 3), dtype=torch.uint8, device=cuda,
                           generator=gen)
    labels = torch.randint(0, 1000, (2,), device=cuda, generator=gen)
    assert A.backward_is_split(785, 32) and not A.backward_is_split(197, 48)
    before = (A.K1.launches, A.K2.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        metrics = step(images, labels)
        torch.cuda.synchronize()
    assert (A.K1.launches - before[0], A.K2.launches - before[1]) == (20, 20)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    calls = {k: sum(e.count for e in prof.key_averages() if k in e.key)
             for k in ("attn_split_dq_kernel", "attn_split_dkv_kernel", "attn_bwd_kernel")}
    assert calls == {"attn_split_dq_kernel": 7, "attn_split_dkv_kernel": 7,
                     "attn_bwd_kernel": 13}, calls


@pytest.mark.gpu
def test_phase_spans_stay_off_the_device_timeline(cuda):
    """On the card the port's ``vst.*`` spans are host operations only (none
    is CUDA-typed, as a ``record_function`` annotation's mirror would be),
    and a bf16 supernet step's host waits on the card at least once inside
    ``vst.train.step``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from test_torch_trace import CLASSES, IMG, NET, PATCH, SPACE
    from vit_search_torch.models import SupernetSchedules, VisionTransformerSR
    from vit_search_torch.train import (OptimConfig, TrainConfig, make_optimizer,
                                        make_train_step)

    batch = 8
    model = VisionTransformerSR(NET, img_size=IMG, patch_size=PATCH, num_classes=CLASSES,
                                patch_output=True, dtype=torch.bfloat16)
    sched = SupernetSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    step = make_train_step(model, make_optimizer(OptimConfig(base_lr=1e-3), model),
                           TrainConfig(num_classes=CLASSES, mixup_mode="token", patch_len=2,
                                       erasing_prob=0.25), counts_unpack=sched.unpack)
    rng = np.random.default_rng(0)
    images = torch.randint(0, 256, (batch, IMG, IMG, 3), dtype=torch.uint8, device=cuda)
    labels = torch.randint(0, CLASSES, (batch,), device=cuda)
    step(images, labels, sched.sample_packed(rng, batch))       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(images, labels, sched.sample_packed(rng, batch))
        torch.cuda.synchronize()
    events = prof.events()
    spans = [e for e in events if e.name.startswith("vst.")]
    assert {e.name for e in spans} >= {"vst.supernet.sample", "vst.train.step",
                                       "vst.train.forward", "vst.train.update"}
    assert not [e.name for e in spans if e.device_type == DeviceType.CUDA]
    (outer,) = [e.time_range for e in spans if e.name == "vst.train.step"]
    syncs = [e for e in events if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                             "cudaEventSynchronize")
             and outer.start <= e.time_range.start < outer.end]
    assert syncs


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst", [(16, 28), (28, 16)], ids=["grow", "shrink"])
def test_pos_embed_interpolation_of_cuda_tensors(cuda, src, dst):
    """The resize of tables on the card equals the CPU's within 1e-5, with
    TF32 matmuls allowed (the resize sums its products elementwise), and
    the token row is copied bit for bit."""
    from vit_search_torch.models import interpolate_pos_embeds

    gen = torch.Generator().manual_seed(src)
    sd = {"pos_embed": torch.randn(1, src * src + 1, 240, generator=gen),
          "blocks.7.pos_embed": torch.randn(1, (src // 2) ** 2, 640, generator=gen)}
    shapes = {"pos_embed": torch.empty(1, dst * dst + 1, 240),
              "blocks.7.pos_embed": torch.empty(1, (dst // 2) ** 2, 640)}
    want = interpolate_pos_embeds(sd, shapes, 1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = interpolate_pos_embeds({k: v.to(cuda) for k, v in sd.items()},
                                     {k: v.to(cuda) for k, v in shapes.items()}, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert float((got[k].cpu() - v).abs().max()) <= 1e-5, k
    assert torch.equal(got["pos_embed"][:, :1].cpu(), sd["pos_embed"][:, :1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kernels_at_the_deit_s_shape(cuda, dtype):
    """K1/K2 at DeiT-S's shape (N = 196 + 2 tokens, 6 heads of 64), one
    launch each per call, against their plain versions."""
    n, h, d = 198, 6, 64
    gen = torch.Generator(device=cuda).manual_seed(198)
    qkv = torch.randn(4, n, 3 * h * d, device=cuda, generator=gen).to(dtype)
    do = torch.randn(4, n, h * d, device=cuda, generator=gen).to(dtype)
    scale = d ** -0.5
    assert A.supported(n, d, 0.0) and not A.backward_is_split(n, d)
    before = (A.K1.launches, A.K2.launches)
    leaf = qkv.clone().requires_grad_()
    out = A.fused_attention_qkv(leaf, scale, h)
    (dqkv,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    assert (A.K1.launches, A.K2.launches) == (before[0] + 1, before[1] + 1)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _close(out, A.attention_qkv_plain(qkv, scale, h), tol)
    _close(dqkv, A.attention_qkv_bwd_plain(qkv, do, scale, h), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixup_distill_dropout_step_matches_the_cpu(cuda, dtype):
    """The small net with a distill token, one step with timm Mixup/CutMix,
    dropout 0.1 and hard distillation from a narrow RegNetY teacher behind a
    resize, on the card against the CPU with the same draws, at
    chip_smoke's tolerances."""
    errs = _reference_net("fused", dtype, distill=True)
    assert set(errs) >= {"loss", "grad_norm", "cls_logits", "dst_logits",
                         "teacher_logits_f32", "teacher_logits_bf16"}


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst", [(112, 96), (64, 96)], ids=["shrink", "grow"])
def test_teacher_resize_and_forward_of_cuda_tensors(cuda, src, dst):
    """The teacher's bicubic resize on the card equals the CPU's within 1e-5
    with TF32 matmuls allowed (it runs in float64); with TF32 off, a narrow
    RegNetYUpsample's float32 logits agree within 1e-4 of the largest."""
    from vit_search_torch.models import RegNetYUpsample, resize_images
    from vit_search_torch.train import make_teacher

    x = torch.randn(4, src, src, 3, generator=torch.Generator().manual_seed(src))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = resize_images(x.to(cuda), dst)
        assert got.device.type == "cuda"
        assert float((got.cpu() - resize_images(x, dst)).abs().max()) <= 1e-5
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        kw = dict(target_size=dst, widths=(32, 64), depths=(1, 2), group_width=16,
                  stem_width=16, num_classes=10, seed=3)
        want = make_teacher(RegNetYUpsample(**kw, device="cpu"))(x)
        logits = make_teacher(RegNetYUpsample(**kw))(x.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert float((logits - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
def test_dropout_model_trains_on_the_card(cuda):
    """A model with dropout and attention dropout takes a step on the card,
    its keep masks drawn from the step's CUDA generator (attention takes the
    plain route under attention dropout: no K1/K2 launch)."""
    from vit_search_torch.models import create_model
    from vit_search_torch.train import OptimConfig, TrainConfig, make_optimizer, make_train_step

    net = ((0, 64), (1, (64, 2, 32), (64, 128), 1), (1, (64, 2, 32), (64, 128), 1),
           (2, 64, 10))
    model = create_model("flexible_vit_patch16_224", network_def=net, img_size=64,
                         dropout_rate=0.1, attn_dropout_rate=0.1, dtype=torch.bfloat16)
    step = make_train_step(model, make_optimizer(OptimConfig(), model),
                           TrainConfig(num_classes=10, mixup_mode="mixup"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8, device=cuda,
                           generator=gen)
    before = A.K1.launches
    metrics = step(images, torch.randint(0, 10, (4,), device=cuda, generator=gen))
    assert np.isfinite(float(metrics["loss"])) and A.K1.launches == before


@pytest.mark.gpu
def test_device_feed_delivers_the_loader_bytes(cuda):
    """The feed's pinned, side-stream copies hand the step exactly the bytes
    the loader produced, also while the consuming stream is busy (each
    batch is read after a spin on the card, so later copies are in flight)."""
    from vit_search_torch import data

    ds = data.SyntheticDataset(num_classes=4, length=12 * 32, img_size=64,
                               transform=data.TrainTransform(size=64))
    loader = data.DataLoader(ds, data.ShardedSampler(len(ds), 1, 0), 32, num_workers=2)
    batches = list(loader)
    fed = 0
    for (images, labels), (want_images, want_labels) in zip(
            data.prefetch_to_device(iter(batches), cuda, depth=3), batches):
        torch.cuda._sleep(2_000_000)
        assert images.device.type == labels.device.type == "cuda"
        assert images.dtype == torch.uint8 and labels.dtype == torch.int64
        assert torch.equal(images.cpu(), torch.from_numpy(want_images))
        assert torch.equal(labels.cpu(), torch.from_numpy(want_labels.astype(np.int64)))
        fed += 1
    assert fed == len(batches) == 12


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cli_two_steps_on_the_card_match_the_cpu(cuda, bf16, tmp_path, monkeypatch):
    """``vit_search_torch.cli.train`` for two supernet steps (token mixup,
    erasing with a constant fill, EMA, eval) on the card against the same
    run with ``--device cpu``: the host draws are the same on both devices
    and the device draws are off (no drop-path, no dropout). float32 with
    TF32 off: the train and eval losses within 1e-4, parameters within 1e-4
    (floor 1e-6); bfloat16: the losses within ``REF_NET_BF16_TOL``."""
    from vit_search_torch.arch import spaces
    from vit_search_torch.cli import train as train_cli
    from vit_search_torch.tools.make_synthfolder import generate
    from vit_search_torch.train import restore_raw

    monkeypatch.setitem(spaces._SPACES, "gpu_cli_112", lambda: CLI_SPACE)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    folder = str(tmp_path / "data")
    generate(folder, num_classes=10, train_per_class=2, val_per_class=1, size=128)
    results = {}
    for device in ("cpu", "cuda"):
        out = str(tmp_path / device)
        argv = ["--model", "flexible_vit_sr_patch14_224_patch_output_supernet",
                "--network-def", repr(CLI_NET), "--search-space", "gpu_cli_112",
                "--example-per-arch", "2", "--use-patch-mixup", "--mixup-patch-len", "2",
                "--input-size", "112", "--data-path", folder, "--batch-size", "8",
                "--val-bs", "5", "--epochs", "1", "--max-steps-per-epoch", "2",
                "--num_workers", "2", "--no-repeated-aug", "--warmup-epochs", "0",
                "--drop-path", "0", "--reprob", "0.5", "--remode", "const",
                "--model-ema-decay", "0.9", "--gelu", "tanh", "--device", device,
                "--output_dir", out] + ([] if bf16 else ["--no-bf16"])
        result = train_cli.main(train_cli.get_args_parser().parse_args(argv))
        results[device] = (result, restore_raw(os.path.join(out, "checkpoints", "checkpoint")))
    (r0, c0), (r1, c1) = results["cpu"], results["cuda"]
    tol = chip_smoke.REF_NET_BF16_TOL["loss"] if bf16 else 1e-4
    for key in ("train_loss", "test_loss", "ema_test_loss"):
        assert math.isclose(r1[key], r0[key], rel_tol=tol), (key, r1[key], r0[key])
    if not bf16:
        for part in ("params", "ema_params"):
            for k, v in c0[part].items():
                chip_smoke.compare(f"{part} {k}", c1[part][k].cpu(), v, (1e-4, 1e-4),
                                   floor=1e-6)


# B1/B2, the conv stem's batch norm: the stem's shapes (B 64, 24 channels at
# 224 and 392 px, half resolution), then ragged ones (3 channels, 7 x 7
# planes, the teacher's 2048 channels without the ReLU)
BN_SHAPES = [((64, 24, 112, 112), torch.bfloat16, True), ((64, 24, 196, 196), torch.bfloat16, True),
             ((8, 3, 20, 20), torch.bfloat16, True), ((16, 24, 7, 7), torch.bfloat16, True),
             ((4, 2048, 7, 7), torch.bfloat16, False), ((4, 2048, 7, 7), torch.float32, False)]
BN_IDS = ["stem224", "stem392", "c3", "hw49", "c2048_bf16", "c2048_f32"]


def _bn_inputs(cuda, shape, dtype, layout, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed + shape[1])
    c = shape[1]
    x = (torch.randn(*shape, device=cuda, generator=gen) * 1.5 + 0.3).to(dtype)
    g = torch.randn(*shape, device=cuda, generator=gen).to(dtype)
    if layout == "channels_last":
        x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
    params = [torch.randn(c, device=cuda, generator=gen) * 0.5 + 1.0,
              torch.randn(c, device=cuda, generator=gen) * 0.5,
              torch.randn(c, device=cuda, generator=gen) * 0.1,
              torch.rand(c, device=cuda, generator=gen) + 0.5]
    return x, g, params


def _bn_run(fn, x, g, params, train, relu):
    """``fn``'s output, running statistics and the gradients of x, w, b."""
    w, b, rm, rv = (t.clone() for t in params)
    w.requires_grad_()
    b.requires_grad_()
    leaf = x.clone().requires_grad_()
    y = fn(leaf, w, b, rm, rv, train, 0.9, 1e-5, relu)
    grads = torch.autograd.grad(y, (leaf, w, b), g)
    return y, rm, rv, grads


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,relu", BN_SHAPES, ids=BN_IDS)
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_kernels_match_the_plain_path(cuda, shape, dtype, relu, layout, train):
    """B1/B2 against the float32 PyTorch ops (and ``F.relu``) on the same
    card: y and dx within bf16 tolerance (f32: 1e-4), the running
    statistics within 1e-5, dw and db within 1e-3 (sums in another order).
    The reference's ReLU is its own; dx is not compared where its float32
    pre-activation lies in ``chip_smoke.relu_kink``'s band, within a few ulps
    of 0, which may hold at most ``chip_smoke.KINK_SHARE`` of the elements."""
    x, g, params = _bn_inputs(cuda, shape, dtype, layout)
    before = (BN.BN_STATS.launches, BN.BN_APPLY.launches, BN.BN_BWD.launches)
    y, rm, rv, (dx, dw, db) = _bn_run(BN.batch_norm, x, g, params, train, relu)
    torch.cuda.synchronize()
    assert (BN.BN_STATS.launches - before[0], BN.BN_APPLY.launches - before[1],
            BN.BN_BWD.launches - before[2]) == (int(train), 1, 1)
    assert y.dtype == dtype and y.stride() == x.stride() and dx.stride() == x.stride()
    ry, rrm, rrv, (rdx, rdw, rdb) = _bn_run(BN.batch_norm_plain, x, g, params, train, relu)
    if relu:
        with torch.no_grad():
            z = BN.batch_norm_plain(x.float(), params[0], params[1], params[2].clone(),
                                    params[3].clone(), train, 0.9, 1e-5, False)
        dx = torch.where(chip_smoke.relu_kink("stem norm", z), rdx, dx)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _close(y, ry, tol)
    _close(rm, rrm, 1e-5)
    _close(rv, rrv, 1e-5)
    _close(dx, rdx, tol)
    _close(dw, rdw, 1e-3)
    _close(db, rdb, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_batch_norm_backward_repeats_its_bits(cuda, layout):
    """No atomics: two forward and backward calls give the same bits."""
    x, g, params = _bn_inputs(cuda, (64, 24, 112, 112), torch.bfloat16, layout, seed=5)
    first = _bn_run(BN.batch_norm, x, g, params, True, True)
    second = _bn_run(BN.batch_norm, x, g, params, True, True)
    for a, b in zip([*first[:3], *first[3]], [*second[:3], *second[3]]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_batch_norm_takes_a_gradient_in_another_layout(cuda):
    """dy stored otherwise than x is read in x's layout."""
    x, g, params = _bn_inputs(cuda, (8, 24, 28, 28), torch.bfloat16, "channels_last")
    want = _bn_run(BN.batch_norm, x, g, params, True, True)[3]
    got = _bn_run(BN.batch_norm, x, g.contiguous(), params, True, True)[3]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda x: x[:, :, :, ::2],
    lambda x: x.float().double(),
    lambda x: x[0],
], ids=["strided", "float64", "3d"])
def test_batch_norm_raises_on_what_the_kernels_refuse(cuda, make):
    x, _, params = _bn_inputs(cuda, (4, 8, 6, 6), torch.bfloat16, "nchw")
    with pytest.raises((ValueError, TypeError)):
        BN.batch_norm(make(x), *params, True, 0.9, 1e-5, True)


@pytest.mark.gpu
def test_the_conv_stem_launches_three_of_each_and_saves_no_float32_activation(cuda):
    """A stem train step: 3 statistics, 3 normalize and 3 backward launches;
    no float32 tensor larger than a channel vector is saved for the
    backward. An eval forward: 3 normalize launches alone."""
    from vit_search_torch.models.patch_embed import PatchConvEmbed

    stem = PatchConvEmbed(224, 14, 240, 24, torch.bfloat16,
                          torch.Generator().manual_seed(0)).to(cuda)
    images = torch.randint(0, 256, (16, 224, 224, 3), device=cuda).float()
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t

    kernels.reset_launches()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = stem(images)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert (BN.BN_STATS.launches, BN.BN_APPLY.launches, BN.BN_BWD.launches) == (3, 3, 3)
    activation = 16 * 24 * 112 * 112
    big = [n for dtype, n in saved if dtype == torch.float32 and n >= activation]
    assert big == [], big
    kernels.reset_launches()
    with torch.no_grad():
        stem.eval()(images)
    assert (BN.BN_STATS.launches, BN.BN_APPLY.launches, BN.BN_BWD.launches) == (0, 3, 0)


@pytest.mark.gpu
def test_batch_norm_in_a_group_of_one_gives_the_bits_without_one(cuda, tmp_path):
    """Train mode in a one-process gloo group (the sums all-reduced between
    the passes, the statistics finished by their own launch): the bits of no
    group."""
    from vit_search_torch import parallel

    x, g, params = _bn_inputs(cuda, (16, 24, 56, 56), torch.bfloat16, "channels_last")
    alone = _bn_run(BN.batch_norm, x, g, params, True, True)
    parallel.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, local_rank=0,
                              device="cuda", backend="gloo")
    try:
        grouped = _bn_run(BN.batch_norm, x, g, params, True, True)
    finally:
        parallel.shutdown()
    for a, b in zip([*alone[:3], *alone[3]], [*grouped[:3], *grouped[3]]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("train,calls", [(True, 1), (False, 0)], ids=["train", "eval"])
def test_batch_norm_backward_all_reduces_only_batch_statistics(cuda, monkeypatch, train, calls):
    """B2 sums over the processes only in train mode: in eval mode the
    running statistics do not depend on x, and dx never reads the sums."""
    x, g, params = _bn_inputs(cuda, (8, 24, 28, 28), torch.bfloat16, "channels_last")
    seen = []
    real = BN.parallel.sum_over_processes

    def counted(t):
        seen.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(BN.parallel, "sum_over_processes", counted)
    _bn_run(BN.batch_norm, x, g, params, train, True)
    assert seen == [(2, 24)] * calls


@pytest.mark.gpu
def test_batch_norm_eval_backward_keeps_the_statistics_of_its_forward(cuda):
    """A train-mode forward between an eval-mode forward and its backward
    moves the running statistics in place; the backward still normalizes by
    those its forward read."""
    x, g, params = _bn_inputs(cuda, (8, 24, 28, 28), torch.bfloat16, "nchw")
    want = _bn_run(BN.batch_norm, x, g, params, False, True)[3]
    w, b, rm, rv = (t.clone() for t in params)
    w.requires_grad_()
    b.requires_grad_()
    leaf = x.clone().requires_grad_()
    y = BN.batch_norm(leaf, w, b, rm, rv, False, 0.9, 1e-5, True)
    BN.batch_norm(x * 3 + 1, w.detach(), b.detach(), rm, rv, True, 0.9, 1e-5, True)
    assert not torch.equal(rm, params[2])
    got = torch.autograd.grad(y, (leaf, w, b), g)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


# --- two processes on the one card against one ---------------------------------
#
# The Tiny supernet's train step (``chip_smoke.supernet_step``) at a global
# batch of DIST_BATCH in two processes on the one card, joined over gloo (NCCL
# refuses two ranks on one card), each with half the rows, against the same
# steps in one process; then the first generation of the search scored on each
# rank's share of the sub-val batches against one process scoring them all.
# Two processes and one differ only in the order of the sums (the gradients',
# the conv stem's batch statistics'): relative limits on the losses, the grad
# norms and the conv stem's running statistics (by norm), each near the
# geometric mean of the sound run's gap and the smallest planted fault's
# (``PLANTED_FAULTS``, each of which must be caught). On an H100 the sound
# run's gaps were 1.2e-5 / 3.6e-4 / 2.2e-6; local drop-path keeps gave 1.1e-3 /
# 6.6e-3 / 8.3e-5; local batch statistics 8.7e-5 / 5.3e-4 / 5.3e-2, and ranks
# that disagree.
DIST_PROCS, DIST_STEPS, DIST_BATCH = 2, 2, 512
DIST_TOL = {"loss": 1e-4, "grad_norm": 1.5e-3, "bn_stats": 1e-5}
# the search: evolutionary_search/tiny.sh's budget, its --arch-batch and
# --val-bs, 20 random candidates over three sub-val batches (the last with 128
# valid rows)
TINY_BUDGET, POPULATION = 1.7944e9, 20
VAL_BATCH, ARCH_BATCH, VAL_BATCHES, LAST_VALID = 256, 8, 3, 128


def _plant_local_bn():
    """Planted fault: the conv stem's batch statistics from this rank's rows
    alone. Returns its undo."""
    from types import SimpleNamespace

    saved = BN.parallel
    BN.parallel = SimpleNamespace(sum_over_processes=lambda x: x, process_count=lambda: 1)
    return lambda: setattr(BN, "parallel", saved)


def _plant_local_drop_path():
    """Planted fault: drop-path keeps drawn at this rank's shape instead of
    cut from the global batch's (no ``RowShard``). Returns its undo."""
    from vit_search_torch.train import engine

    saved = engine.RowShard
    engine.RowShard = lambda generator, *rows: generator
    return lambda: setattr(engine, "RowShard", saved)


PLANTED_FAULTS = {"local_bn_stats": _plant_local_bn, "local_drop_path": _plant_local_drop_path}


def _launches() -> dict:
    """Each kernel's launches since the last reset, 0 for one not imported."""
    counted = {k.name: k.launches for k in kernels.KERNELS}
    return {name: counted.get(name, 0) for name in chip_smoke.KERNEL_NAMES}


def _dist_steps(images, labels) -> dict:
    """``DIST_STEPS`` steps of the Tiny supernet at the global batch on this
    process's rows: the losses, grad norms, the conv stem's running
    statistics, and each kernel's launches."""
    import gc

    step, sched = chip_smoke.supernet_step(batch=DIST_BATCH)
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    metrics = [step(images, labels, sched.sample_packed(rng, DIST_BATCH))
               for _ in range(DIST_STEPS)]
    out = {"losses": [float(m["loss"]) for m in metrics],
           "grad_norms": [float(m["grad_norm"]) for m in metrics],
           "bn_stats": {name: b.tolist() for name, b in step.model.named_buffers()
                        if name.endswith(("running_mean", "running_var"))},
           "launches": _launches()}
    del step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sub_val_loader():
    """Synthetic sub-val batches of uint8 images on the card, the same at
    every call; the last batch has ``LAST_VALID`` valid rows."""
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


def _score(loader) -> dict:
    """The native generators' first ``POPULATION`` candidates under the Tiny
    budget, scored on ``loader`` by the full-width supernet (bf16, the fused
    route), ``ARCH_BATCH`` per forward."""
    from vit_search_torch.arch import ComputationEstimator, presets, spaces
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.search import BatchedSupernetEvaluator, PopulationEvolver

    net, space = presets.SUPERNET_SR_TINY_MH, spaces.get_space("sr_tiny_mh")
    model = create_model("flexible_vit_sr_patch14_224_patch_output_supernet", network_def=net,
                         dtype=torch.bfloat16, gelu="tanh", seed=0)
    est = ComputationEstimator(distill=False, input_resolution=224, patch_size=14)
    evolver = PopulationEvolver(net, space, TINY_BUDGET, est, seed=0, backend="native")
    evolver.random_sample(POPULATION)
    defs = [ind.network_def for ind in evolver.popu]
    evaluator = BatchedSupernetEvaluator(
        model, SupernetSchedules(net, space, example_per_arch=1, num_warmup_epochs=0), loader,
        arch_batch=ARCH_BATCH, score_head="cls")
    kernels.reset_launches()
    scores = evaluator.score(defs)
    return {"network_defs": [repr(d) for d in defs], "scores": list(map(float, scores)),
            "launches": _launches(), "forwards": -(-len(defs) // ARCH_BATCH) * len(loader)}


def _dist_worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank: the steps on its rows, the same steps under each planted
    fault, then the candidates scored on its share of the sub-val batches;
    its readings to ``out/rank<rank>.json``."""
    from vit_search_torch import parallel

    parallel.init_distributed(f"file://{store}", world, rank, local_rank=0, device="cuda",
                              backend="gloo")
    images, labels = chip_smoke.synthetic_batch(DIST_BATCH, 224, 0)
    lo, hi = parallel.batch_slice(DIST_BATCH)
    rows = images[lo:hi].contiguous(), labels[lo:hi].contiguous()
    report = {"two_ranks": _dist_steps(*rows)}
    for fault, plant in PLANTED_FAULTS.items():
        undo = plant()
        try:
            report[fault] = _dist_steps(*rows)
        finally:
            undo()
    report["score"] = _score(_sub_val_loader()[rank::world])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    parallel.shutdown()


def _env(**extra) -> dict:
    """This process's environment with the repository importable and no
    process group's variables but ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return {**env, **extra}


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """The two ranks' readings, and the same steps and scoring in this
    process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = tmp_path_factory.mktemp("dist")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(DIST_PROCS), str(out / "store"), str(out)],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(DIST_PROCS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-6000:]}"
    ranks = []
    for r in range(DIST_PROCS):
        with open(out / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:   # supernet_step turns TF32 on, in the ranks as here
        one = {"steps": _dist_steps(*chip_smoke.synthetic_batch(DIST_BATCH, 224, 0)),
               "score": _score(_sub_val_loader())}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return ranks, one


def _gaps(got: dict, want: dict) -> dict:
    """Relative gaps of two runs' readings: the largest over the steps for
    the losses and grad norms, the largest by norm over the statistics."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    bn = [math.dist(got["bn_stats"][k], v) / math.hypot(*v) for k, v in want["bn_stats"].items()]
    return {"loss": max(map(rel, got["losses"], want["losses"])),
            "grad_norm": max(map(rel, got["grad_norms"], want["grad_norms"])),
            "bn_stats": max(bn)}


def _nccl_launch(tmp_path) -> None:
    """``python -m vit_search_torch.cli.launch`` as torchrun starts it, one
    process on NCCL (a group of one runs every collective): one epoch of two
    steps of ``super_net/tiny.sh``'s own arguments at ``DIST_BATCH`` on a
    1000-class folder of three 32 px images a class, one held out. The
    loader crops and resizes each image to 224 px on the host, so the card
    sees the batch a full-size folder gives; host decode at full size is
    ``tools/loader_check.py``'s."""
    from vit_search_torch.data import build_subsets
    from vit_search_torch.tools.make_synthfolder import generate

    folder, out = str(tmp_path / "data"), str(tmp_path / "launch")
    generate(folder, num_classes=1000, train_per_class=3, val_per_class=0, size=32, workers=4)
    build_subsets(folder, per_class=1, seed=0)
    _, argv = chip_smoke.script_command(os.path.join(chip_smoke.RECIPE_DIR, chip_smoke.TINY))
    argv = chip_smoke.with_flags(argv, {"--data-path": folder, "--batch-size": str(DIST_BATCH),
                                        "--epochs": "1", "--max-steps-per-epoch": "2",
                                        "--output_dir": out, "--num_workers": "4"})
    torch.cuda.empty_cache()   # this process's cached blocks to the launched one
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.run([sys.executable, "-m", "vit_search_torch.cli.launch", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=900,
                          env=_env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(out, "verbose.log")) as f:
        group = next((line for line in f if "over nccl" in line), "")
    assert "rank 0 of 1 over nccl" in group, group
    with open(os.path.join(out, "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["epoch"] for line in lines] == [0] and math.isfinite(lines[0]["train_loss"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["two_ranks", *PLANTED_FAULTS, "nccl_launch"])
def test_two_processes_on_the_card_match_one(cuda, case, request, tmp_path):
    """``two_ranks``: both ranks equal bit for bit, within ``DIST_TOL`` of
    one process, each kernel launched as ``recipe_launches`` counts a Tiny
    supernet step or scoring forward, and the scores equal to one process's
    bit for bit. A planted fault: caught, by the ranks' disagreement or by a
    gap over ``DIST_TOL``. ``nccl_launch``: ``cli.launch`` on NCCL."""
    if case == "nccl_launch":
        _nccl_launch(tmp_path)
        return
    ranks, one = request.getfixturevalue("dist_runs")
    keys = ("losses", "grad_norms", "bn_stats")
    got = [{k: r[case][k] for k in keys} for r in ranks]
    agree = all(g == got[0] for g in got)
    gaps = _gaps(got[0], one["steps"])
    over = [k for k, tol in DIST_TOL.items() if gaps[k] > tol]
    print(f"dist {case}: gaps of two processes to one {json.dumps(gaps)} (limits "
          f"{json.dumps(DIST_TOL)}), ranks agree: {agree}")
    if case != "two_ranks":
        assert not agree or over, f"{case} not caught: {gaps}"
        return
    assert agree and not over, gaps
    step, forward = chip_smoke.recipe_launches(*chip_smoke.recipe_net(chip_smoke.TINY))
    for r in ranks:
        assert r["two_ranks"]["launches"] == {k: DIST_STEPS * v for k, v in step.items()}
        score = r["score"]
        assert score["launches"] == {k: score["forwards"] * v for k, v in forward.items()}
        assert (score["network_defs"], score["scores"]) == (one["score"]["network_defs"],
                                                            one["score"]["scores"])


if __name__ == "__main__":
    _dist_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
