"""The port's hand-written CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
when there is none. Shapes are main-path-like (the three ViT-ResNAS-Tiny
stages) at a small batch. This file imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from vit_search_torch.ops import attention as A
from vit_search_torch.ops import kernels
from vit_search_torch.ops import masked_layer_norm as M
from vit_search_torch.ops import stats as S
from vit_search_torch.ops.masking import make_channel_mask
from vit_search_torch.tools import attn_lab as L

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


@pytest.mark.gpu
def test_reference_net_in_bf16_matches_the_cpu(cuda):
    """The small supernet in bf16 on the card (tensor-core attention) against
    the same net on the CPU (plain versions), at chip_smoke's tolerance."""
    import chip_smoke

    errs = chip_smoke.check_reference_net("fused", torch.bfloat16)
    assert set(errs) >= {"loss", "grad_norm", "cls_logits", "patch_logits"}


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
    import chip_smoke

    errs = chip_smoke.check_reference_net("fused", dtype, dense=True)
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
    import chip_smoke

    errs = chip_smoke.check_reference_net("fused", dtype, distill=True)
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


# a supernet of three stages at 112 px (chip_smoke's reference net), 10 classes
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


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cli_two_steps_on_the_card_match_the_cpu(cuda, bf16, tmp_path, monkeypatch):
    """``vit_search_torch.cli.train`` for two supernet steps (token mixup,
    erasing with a constant fill, EMA, eval) on the card against the same
    run with ``--device cpu``: the host draws are the same on both devices
    and the device draws are off (no drop-path, no dropout). float32 with
    TF32 off: the train and eval losses within 1e-4, parameters within 1e-4
    (floor 1e-6); bfloat16: the losses within ``REF_NET_BF16_TOL``."""
    import math

    import chip_smoke
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
