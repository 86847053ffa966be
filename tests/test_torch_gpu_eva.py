"""The streaming rotary attention (R1/R2, ``csrc/attention_rope.cu``), the
SwiGLU sub-LN (G1/G2, ``csrc/swiglu_ln.cu``) and EVA-02 on the card, against
their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
when there is none (the kernels are CUDA only). This file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_eva.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from vit_search_torch import models, train
from vit_search_torch.models import eva02
from vit_search_torch.ops import attention as A
from vit_search_torch.ops import kernels
from vit_search_torch.ops import rope_attention as R
from vit_search_torch.ops import swiglu_ln as S

# EVA-02-L at 448 px: N = 1 + 32 x 32 tokens, 16 heads of 64
N, HEADS, D, HIDDEN = 1025, 16, 64, 2730


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, tol=2e-2):
    """The attention kernels' bf16 rule: within ``tol`` of the largest entry
    plus ``tol`` relative."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    bound = tol * want.abs().max() + tol * want.abs()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= bound).all(), float((got - want).abs().max())


def _tables(cuda):
    return tuple(t.to(cuda) for t in eva02.rope_tables(32, D))


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False], ids=["tables", "no_tables"])
def test_rope_attention_matches_plain(cuda, rope):
    """R1's output and log-sum-exp and R2's packed cotangent at B 4, N 1025,
    d 64, one counted call each way, against the plain float32 function of
    the same bf16 projection (the kernels round rotated q and k, p and ds to
    bf16 as MMA operands: the bf16 rule)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(4, N, 3 * HEADS * D, device=cuda, generator=gen).bfloat16()
    g = torch.randn(4, N, HEADS * D, device=cuda, generator=gen).bfloat16()
    tables = _tables(cuda) if rope else None
    scale = D ** -0.5
    before = (R.R1.launches, R.R2.launches)
    leaf = qkv.clone().requires_grad_()
    out = R.rope_attention(leaf, tables, scale, HEADS)
    (dqkv,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    assert (R.R1.launches, R.R2.launches) == (before[0] + 1, before[1] + 1)
    want, lse = R.rope_attention_plain(qkv.float(), tables, scale, HEADS)
    _close(out, want)
    _, got_lse = R.rope_attention_fwd_cuda(qkv, tables, scale, HEADS)
    assert float((got_lse.cpu() - lse.cpu()).abs().max()) < 2e-2
    _close(dqkv, R.rope_attention_bwd_plain(qkv.float(), g.float(), tables, scale, HEADS))


@pytest.mark.gpu
def test_rope_attention_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, N, 3 * HEADS * D, device=cuda, generator=gen).bfloat16()
    g = torch.randn(2, N, HEADS * D, device=cuda, generator=gen).bfloat16()
    runs = []
    for _ in range(2):
        leaf = qkv.clone().requires_grad_()
        out = R.rope_attention(leaf, _tables(cuda), D ** -0.5, HEADS)
        runs.append((out, *torch.autograd.grad(out, leaf, g)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,streaming", [(257, 64, False), (785, 32, False), (197, 48, False),
                                           (1025, 64, True), (737, 64, True)])
def test_packed_attention_route(cuda, n, d, streaming):
    """``fused_attention_qkv`` keeps every shape K1/K2 hold on K1/K2 (the
    cells' N 257 at d 64, 785 at d 32, 197 at d 48) and sends the bf16
    shapes past their shared memory to R1/R2 without tables, whose result
    is the plain attention's."""
    heads = 4
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    qkv = torch.randn(2, n, 3 * heads * d, device=cuda, generator=gen).bfloat16()
    g = torch.randn(2, n, heads * d, device=cuda, generator=gen).bfloat16()
    assert R.k1_fits(n, d) != streaming
    before = [k.launches for k in (A.K1, A.K2, R.R1, R.R2)]
    leaf = qkv.clone().requires_grad_()
    out = A.fused_attention_qkv(leaf, d ** -0.5, heads)
    (dqkv,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    moved = [k.launches - b for k, b in zip((A.K1, A.K2, R.R1, R.R2), before)]
    assert moved == ([0, 0, 1, 1] if streaming else [1, 1, 0, 0])
    _close(out, A.attention_qkv_plain(qkv.float(), d ** -0.5, heads))
    _close(dqkv, A.attention_qkv_bwd_plain(qkv.float(), g.float(), d ** -0.5, heads))


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,pitch", [(HIDDEN, HIDDEN), (HIDDEN, 2736), (170, 170),
                                          (171, 171), (170, 176)])
def test_swiglu_ln_matches_plain(cuda, hidden, pitch):
    """G1's output and saved statistics and G2's packed cotangent and the
    norm's weight and bias gradients, at EVA-02-L's 2730 (even, not a
    multiple of 4) over 4 x 1025 rows, unpadded and at the model's pitch of
    2736, and at 170 and 171 (the odd route), one counted call each way,
    against the plain float32 function of the same bf16 input (the outputs
    are rounded to bf16: the bf16 rule; the gradients of the norm's
    parameters, float32 sums over every row, 1e-3 of the largest plus 1e-3
    relative). The padding of u and of the cotangent holds noise, which the
    kernels leave alone; they write zeros into the padding of y and du."""
    rows = 4 * N if hidden == HIDDEN else 4 * 197
    gen = torch.Generator(device=cuda).manual_seed(hidden + pitch)
    u = (2 * torch.randn(rows, 2 * pitch, device=cuda, generator=gen)).bfloat16()
    g = torch.randn(rows, pitch, device=cuda, generator=gen).bfloat16()
    w = 1 + 0.1 * torch.randn(hidden, device=cuda, generator=gen)
    b = 0.1 * torch.randn(hidden, device=cuda, generator=gen)
    before = (S.G1.launches, S.G2.launches)
    leaves = [u.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
    y = S.swiglu_ln(*leaves, 1e-6)
    du, dw, db = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert (S.G1.launches, S.G2.launches) == (before[0] + 1, before[1] + 1)
    assert y.shape == (rows, pitch) and du.shape == u.shape
    _close(y, S.swiglu_ln_plain(u.float(), w, b, 1e-6))
    stats = S.swiglu_ln_stats_plain(u, 1e-6, hidden)
    _, got_stats = S.swiglu_ln_fwd_cuda(u, w, b, 1e-6)
    _close(got_stats, stats, 1e-4)
    want = S.swiglu_ln_bwd_plain(u, w, stats, g)
    _close(du, want[0])
    _close(dw, want[1], 1e-3)
    _close(db, want[2], 1e-3)
    if pitch > hidden:
        assert not y[:, hidden:].any() and not du.view(rows, 2, pitch)[:, :, hidden:].any()


@pytest.mark.gpu
def test_swiglu_ln_refuses_what_it_cannot_take(cuda):
    with pytest.raises((ValueError, TypeError)):
        S.swiglu_ln(torch.zeros(4, 2 * 4098, device=cuda, dtype=torch.bfloat16),
                    torch.ones(4098, device=cuda), torch.zeros(4098, device=cuda))
    with pytest.raises((ValueError, TypeError)):
        S.swiglu_ln(torch.zeros(4, 2 * HIDDEN, device=cuda), torch.ones(HIDDEN, device=cuda),
                    torch.zeros(HIDDEN, device=cuda))


def _depth2(cuda, dtype, device):
    return models.create_model("eva02_large_patch14_448", depth=2, num_classes=10,
                               drop_path_rate=0.0, seed=3, dtype=dtype, device=device)


@pytest.mark.gpu
def test_depth2_eva02_on_the_card_matches_the_cpu(cuda):
    """EVA-02-L's widths at 448 px (N 1025), two blocks, two images: the
    bf16 card's logits against the float32 CPU's within bf16's rounding
    (5e-2 of the largest entry), each leaf's gradient norm within 5% of the
    CPU's, against the larger of the leaf's norm and the median leaf's (as
    the benchmark's train cells measure it), and all the gradients together
    at a cosine of 0.99 or more. Layer-norm weights off 1 so that every leaf
    moves."""
    cpu, card = _depth2(cuda, torch.float32, "cpu"), _depth2(cuda, torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
            if p.ndim == 1 and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif p.ndim == 1:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            q.copy_(p)
    images = torch.randn(2, 448, 448, 3, generator=gen)
    kernels.reset_launches()
    logits = [m(x) for m, x in ((cpu, images), (card, images.to(cuda)))]
    _close(logits[1], logits[0], 5e-2)
    for lg in logits:
        lg.float().square().mean().backward()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    print(f"depth-2 EVA-02-L forward and backward launches: {launches}")
    assert launches == {"rope_attention_fwd": 2, "rope_attention_bwd": 2, "swiglu_ln_fwd": 2,
                        "swiglu_ln_bwd": 2, "layer_norm_fwd": 7, "layer_norm_bwd": 7}
    names = [n for n, _ in cpu.named_parameters()]
    got = [q.grad.float().cpu().flatten() for q in card.parameters()]
    want = [p.grad.flatten() for p in cpu.parameters()]
    floor = torch.stack([w.norm() for w in want]).median()
    gaps = {n: float((g.norm() - w.norm()).abs() / torch.maximum(w.norm(), floor))
            for n, g, w in zip(names, got, want)}
    print("eva depth-2 grad gaps: worst " + ", ".join(
        f"{n} {v:.3g}" for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:4]))
    bad = {n: v for n, v in gaps.items() if v > 0.05}
    assert not bad, bad
    assert float(F.cosine_similarity(torch.cat(got), torch.cat(want), dim=0)) >= 0.99


@pytest.mark.gpu
def test_eva02_train_step_launches(cuda):
    """One train step of the depth-2 EVA-02-L at 448 px with the cell's
    recipe (AdamW with layer decay, Mixup/CutMix, erasing, drop path, EMA):
    R1/R2 and G1/G2 once a block, the dense K3/K4 once each of its 7 layer
    norms (three a block and ``fc_norm``), M2 once a branch whose drop-path
    rate is above 0 and M3 as its backward, and no other kernel; no RoPE in
    PyTorch and no K3d/K4d at 2730."""
    torch.cuda.empty_cache()
    model = models.create_model("eva02_large_patch14_448", depth=2, drop_path_rate=0.15,
                                dtype=torch.bfloat16, device=cuda)
    ocfg = train.OptimConfig(base_lr=2.5e-5, warmup_epochs=2, epochs=30, layer_decay=0.85,
                             global_batch_size=768)
    step = train.make_train_step(model, train.make_optimizer(ocfg, model),
                                 train.TrainConfig(mixup_mode="mixup", erasing_prob=0.25,
                                                   ema_decay=0.9999),
                                 schedule=train.lr_schedule(ocfg), device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randint(0, 256, (8, 448, 448, 3), dtype=torch.uint8, device=cuda,
                           generator=gen)
    labels = torch.randint(0, 1000, (8,), device=cuda, generator=gen)
    kernels.reset_launches()
    metrics = step(images, labels)
    torch.cuda.synchronize()
    assert math.isfinite(float(metrics["loss"]))
    launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    print(f"depth-2 EVA-02-L step launches: {launches}")
    assert launches == {"rope_attention_fwd": 2, "rope_attention_bwd": 2, "swiglu_ln_fwd": 2,
                        "swiglu_ln_bwd": 2, "layer_norm_fwd": 7, "layer_norm_bwd": 7,
                        "branch_add": 2, "prefix_scale": 2}
    del model, step, metrics
    torch.cuda.empty_cache()
