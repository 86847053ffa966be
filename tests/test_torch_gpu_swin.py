"""The windowed cosine-attention kernels (``csrc/window_attention.cu``) and
SwinV2 on the card, against their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
when there is none (the kernels are CUDA only). This file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_swin.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from vit_search_torch import models, train
from vit_search_torch.models import swin_v2
from vit_search_torch.ops import kernels
from vit_search_torch.ops import window_attention as W

# SwinV2-B at 256 px, 256 images: (windows B * nW, N, heads, shifted), the
# shifted blocks' stage resolution
STAGES = [(4096, 256, 4, False, 64), (4096, 256, 4, True, 64), (1024, 256, 8, False, 32),
          (1024, 256, 8, True, 32), (256, 256, 16, False, 16), (256, 64, 32, False, 8)]
IDS = ["stage1", "stage1_shifted", "stage2", "stage2_shifted", "stage3", "stage4"]


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


def inputs(cuda, bw, n, h, shifted, r, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed + n + h)
    qkv = torch.randn(bw, n, 3 * h * 32, device=cuda, generator=gen).bfloat16()
    g = torch.randn(bw, n, h * 32, device=cuda, generator=gen).bfloat16()
    scale = torch.exp(torch.rand(h, device=cuda, generator=gen) * math.log(100.0))
    bias = 16 * torch.sigmoid(torch.randn(h, n, n, device=cuda, generator=gen))
    regions = swin_v2.shift_regions(r, 16, 8).to(cuda) if shifted else None
    return qkv, g, scale, bias, regions


@pytest.mark.gpu
@pytest.mark.parametrize("bw,n,h,shifted,r", STAGES, ids=IDS)
def test_window_attention_matches_plain(cuda, bw, n, h, shifted, r):
    """Out, dqkv, the bias's and the scale's gradients at the cell's stage
    shapes, one counted call each way, against the plain function in
    float32 from the same bf16 projection with q' and k' rounded as the
    kernels round them; the kernels also round p and ds to bf16 as operands
    (2e-2 of the largest entry plus 2e-2 relative, the attention kernels'
    bf16 rule)."""
    qkv, g, scale, bias, regions = inputs(cuda, bw, n, h, shifted, r)
    leaves = [qkv.clone().requires_grad_(), scale.clone().requires_grad_(),
              bias.clone().requires_grad_()]
    before = (W.WA_FWD.launches, W.WA_BWD.launches)
    out = W.window_attention(leaves[0], leaves[1], leaves[2], regions, h)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (W.WA_FWD.launches, W.WA_BWD.launches) == (before[0] + 1, before[1] + 1)
    ref_leaves = [qkv.float().requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
    ref = W.window_attention_plain(*ref_leaves, regions, h, rounded=True)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g.float())
    _close(out, ref)
    for got, want in zip(grads, ref_grads):
        _close(got, want)


@pytest.mark.gpu
def test_window_attention_is_deterministic(cuda):
    qkv, g, scale, bias, regions = inputs(cuda, 1024, 256, 8, True, 32, seed=5)
    runs = []
    for _ in range(2):
        leaves = [qkv.clone().requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        out = W.window_attention(leaves[0], leaves[1], leaves[2], regions, 8)
        runs.append([out, *torch.autograd.grad(out, leaves, g)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["f32", "head_dim", "length", "heads", "regions"])
def test_refused_inputs_raise(cuda, what):
    qkv, _, scale, bias, _ = inputs(cuda, 16, 64, 2, False, 8)
    regions = None
    if what == "f32":
        qkv = qkv.float()
    elif what == "head_dim":
        qkv = torch.zeros(16, 64, 3 * 2 * 48, device=cuda, dtype=torch.bfloat16)
    elif what == "length":
        qkv, bias = qkv[:, :49].contiguous(), bias[:, :49, :49].contiguous()
    elif what == "heads":
        qkv = torch.zeros(16, 64, 3 * 3 * 32, device=cuda, dtype=torch.bfloat16)
        scale, bias = torch.ones(3, device=cuda), torch.zeros(3, 64, 64, device=cuda)
    else:
        regions = torch.zeros(3, 64, dtype=torch.int32, device=cuda)   # 16 % 3 != 0
    with pytest.raises((ValueError, TypeError)):
        W.window_attention(qkv, scale, bias, regions, 3 if what == "heads" else 2)


@pytest.mark.gpu
def test_small_swin_step_on_the_card_matches_the_cpu(cuda):
    """SwinV2 at 128 px, embed 32, window 4 (stage 4 one 4 x 4 window):
    the bf16 card's logits against the float32 CPU's within bf16's rounding
    over 8 blocks (5e-2 of the largest entry); each leaf's gradient norm
    within 5% of the CPU's, measured as the benchmark's train cells measure
    it (against the larger of the leaf's norm and the median leaf's: the
    bias MLP's and the scale's gradients are sums that nearly cancel, since
    each row of a softmax's gradient sums to 0), and all the gradients
    together at a cosine of 0.99 or more."""
    kw = dict(img_size=128, embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
              window_size=4, num_classes=10, drop_path_rate=0.0, seed=3)
    cpu = models.create_model("swinv2_base_window16_256", device="cpu", **kw)
    card = models.create_model("swinv2_base_window16_256", device=cuda, dtype=torch.bfloat16,
                               **kw)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
            if "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            q.copy_(p)
    images = torch.randn(8, 128, 128, 3, generator=gen)
    launches = W.WA_FWD.launches
    logits = [m(x) for m, x in ((cpu, images), (card, images.to(cuda)))]
    assert W.WA_FWD.launches == launches + 8
    _close(logits[1], logits[0], 5e-2)
    for lg in logits:
        lg.float().square().mean().backward()
    names = [n for n, _ in cpu.named_parameters()]
    got = [q.grad.float().cpu().flatten() for q in card.parameters()]
    want = [p.grad.flatten() for p in cpu.parameters()]
    norms = torch.stack([w.norm() for w in want])
    floor = norms.median()
    gaps = {n: float((g.norm() - w.norm()).abs() / torch.maximum(w.norm(), floor))
            for n, g, w in zip(names, got, want)}
    bad = {n: v for n, v in gaps.items() if v > 0.05}
    assert not bad, bad
    assert float(F.cosine_similarity(torch.cat(got), torch.cat(want), dim=0)) >= 0.99


@pytest.mark.gpu
def test_swinv2_base_step_launches_each_window_kernel_once_a_block(cuda):
    """One train step of the full SwinV2-B at 256 px and 256 images, with
    the recipe's optimizer, mixup and erasing (the ``swinv2_base.train``
    cell's): W1 and W2 once each of its 24 blocks (depths 2, 2, 18, 2), the
    dense K3/K4 once each of its 53 layer norms (two a block, the patch
    embedding's, three patch merges', the final one), and no other kernel."""
    torch.cuda.empty_cache()
    model = models.create_model("swinv2_base_window16_256", dtype=torch.bfloat16, device=cuda)
    ocfg = train.OptimConfig(base_lr=5e-4, min_lr=1e-5, warmup_lr=1e-6, warmup_epochs=20,
                             epochs=300, clip_grad=5.0, global_batch_size=1024)
    step = train.make_train_step(model, train.make_optimizer(ocfg, model),
                                 train.TrainConfig(mixup_mode="mixup", erasing_prob=0.25),
                                 schedule=train.lr_schedule(ocfg), device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randint(0, 256, (256, 256, 256, 3), dtype=torch.uint8, device=cuda,
                           generator=gen)
    labels = torch.randint(0, 1000, (256,), device=cuda, generator=gen)
    kernels.reset_launches()
    metrics = step(images, labels)
    torch.cuda.synchronize()
    assert math.isfinite(float(metrics["loss"]))
    launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    print(f"SwinV2-B step launches: {launches}")
    assert launches == {"window_attention_fwd": 24, "window_attention_bwd": 24,
                        "layer_norm_fwd": 53, "layer_norm_bwd": 53}
    del model, step, metrics
    torch.cuda.empty_cache()
