"""The conv stem's batch norm (``ops/batch_norm.py``) on the CPU: its plain
route gives the bits that ``BatchNorm`` and ``ConvBnAct`` gave as float32
PyTorch ops in the module, in train and eval mode, with and without the
ReLU; the kernels' view of a tensor's layout; the CUDA wrappers refuse a CPU
tensor; the card's check of B1/B2 (``chip_smoke.check_relu_norm``) fails a
norm whose ReLU is wrong."""

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from vit_search_torch.models.patch_embed import BatchNorm, ConvBnAct, PatchConvEmbed
from vit_search_torch.ops import batch_norm as BN
from vit_search_torch.ops import kernels


def module_bn(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``BatchNorm.forward`` as the module computed it in one process."""
    xf = x.float()
    if bn.training:
        sums = torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
        n = xf.numel() // xf.shape[1]
        mean = sums[0] / n
        var = (sums[1] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            bn.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
    return y.to(x.dtype)


def _pair(c: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    bns = [BatchNorm(c), BatchNorm(c)]
    w = torch.randn(c, generator=gen)
    b = torch.randn(c, generator=gen)
    rm = torch.randn(c, generator=gen)
    rv = torch.rand(c, generator=gen) + 0.5
    for bn in bns:
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
            bn.running_mean.copy_(rm)
            bn.running_var.copy_(rv)
    return bns, gen


LAYOUTS = ["nchw", "channels_last"]


def _x(gen, shape, dtype, layout):
    x = (torch.randn(*shape, generator=gen) * 1.5 + 0.3).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    return x


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("relu", [False, True], ids=["norm", "norm_relu"])
def test_plain_route_gives_the_module_bits(layout, dtype, train, relu):
    """Output, running statistics and the gradients of x, w and b bit for
    bit equal to the module's float32 ops (and ``F.relu`` after them)."""
    (got_bn, want_bn), gen = _pair(5, 3)
    got_bn.train(train)
    want_bn.train(train)
    x = _x(gen, (4, 5, 6, 7), dtype, layout)
    g = torch.randn(4, 5, 6, 7, generator=gen).to(dtype)
    xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]
    got = got_bn.normalize(xs[0], relu)
    want = module_bn(want_bn, xs[1])
    want = F.relu(want) if relu else want
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(got_bn.running_mean, want_bn.running_mean)
    assert torch.equal(got_bn.running_var, want_bn.running_var)
    got_grads = torch.autograd.grad(got, (xs[0], got_bn.weight, got_bn.bias), g)
    want_grads = torch.autograd.grad(want, (xs[1], want_bn.weight, want_bn.bias), g)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_conv_bn_act_and_batch_norm_forward_keep_their_bits(train):
    """``ConvBnAct`` is conv, the module's norm, ``F.relu``; ``BatchNorm``'s
    forward is the norm alone."""
    gen = torch.Generator().manual_seed(0)
    layer = ConvBnAct(3, 8, 2, torch.float32, gen).train(train)
    ref = ConvBnAct(3, 8, 2, torch.float32, torch.Generator().manual_seed(0)).train(train)
    x = torch.randn(2, 3, 10, 10, generator=gen)
    y = layer(x)
    conv = F.conv2d(x, ref.conv.weight, None, ref.conv.stride, ref.conv.padding)
    assert torch.equal(y, F.relu(module_bn(ref.bn, conv)))
    assert torch.equal(layer.bn.running_var, ref.bn.running_var)
    assert torch.equal(layer.bn(conv), module_bn(ref.bn, conv))


def test_the_stem_trains_on_the_plain_route_and_moves_its_statistics():
    stem = PatchConvEmbed(28, 14, 16, 24, torch.float32, torch.Generator().manual_seed(1))
    x = torch.randn(2, 28, 28, 3, generator=torch.Generator().manual_seed(2))
    before = [m.running_mean.clone() for m in stem.modules() if isinstance(m, BatchNorm)]
    stem(x).square().mean().backward()
    after = [m.running_mean for m in stem.modules() if isinstance(m, BatchNorm)]
    assert len(after) == 3 and all(not torch.equal(a, b) for a, b in zip(after, before))
    assert all(torch.isfinite(p.grad).all() for p in stem.parameters())


@pytest.mark.parametrize("shape,layout,view", [
    ((4, 24, 112, 112), "nchw", (4, 24, 112 * 112)),
    ((4, 24, 112, 112), "channels_last", (4 * 112 * 112, 24, 1)),
    ((2, 3, 7, 7), "channels_last", (2 * 49, 3, 1)),
    ((2, 2048, 7, 7), "nchw", (2, 2048, 49)),
    ((3, 5, 1, 1), "channels_last", (3, 5, 1)),
    ((3, 1, 4, 4), "channels_last", (3, 1, 16)),
], ids=["stem_nchw", "stem_nhwc", "c3", "c2048", "hw1", "c1"])
def test_kernel_view_reads_the_layout_in_place(shape, layout, view):
    x = torch.empty(shape)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    assert BN.kernel_view(x) == view


@pytest.mark.parametrize("make", [
    lambda: torch.empty(4, 6, 5, 5)[:, ::2],
    lambda: torch.empty(4, 5, 5, 6).transpose(1, 3),
    lambda: torch.empty(4, 5, 6),
], ids=["strided", "transposed", "3d"])
def test_kernel_view_refuses_other_layouts(make):
    with pytest.raises(ValueError):
        BN.kernel_view(make())


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.randn(2, 3, 4, 4)
    stats = [torch.zeros(3), torch.ones(3), torch.ones(3), torch.zeros(3)]
    with pytest.raises(ValueError, match="CUDA"):
        BN.batch_norm_apply_cuda(x, *stats, 1e-5, True)
    with pytest.raises(ValueError, match="CUDA"):
        BN.batch_stats_cuda(x, stats[0], stats[1], 0.9)
    with pytest.raises(ValueError, match="CUDA"):
        BN.batch_norm_bwd_cuda(x, x, *stats, 1e-5, True, 0.5)


def test_three_records_count_the_kernels():
    names = {k.name: k for k in kernels.KERNELS}
    for record in (BN.BN_STATS, BN.BN_APPLY, BN.BN_BWD):
        assert names[record.name] is record
        assert record.source == "vit_search_torch/csrc/batch_norm.cu"
    assert "batch_norm" in kernels.SOURCES


def _run_norm(fn, x, g, params, train):
    """``fn``'s output, running statistics and, in train mode, the gradients
    of x, w and b (``chip_smoke.check_relu_norm``'s tuple)."""
    w, b, rm, rv = (t.clone() for t in params)
    leaf, w, b = (t.requires_grad_(train) for t in (x.clone(), w, b))
    with torch.set_grad_enabled(train):
        y = fn(leaf, w, b, rm, rv, train, 0.9, 1e-5, True)
        grads = torch.autograd.grad(y, (leaf, w, b), g) if train else ()
    return y.detach(), rm, rv, grads


def _zero_below_half(leaf, w, b, rm, rv, train, momentum, eps, relu):
    z = BN.batch_norm_plain(leaf, w, b, rm, rv, train, momentum, eps, False)
    return z * (z.detach() > 0.5)


def _zeros(leaf, w, b, rm, rv, train, momentum, eps, relu):
    return BN.batch_norm_plain(leaf, w, b, rm, rv, train, momentum, eps, False) * 0


@pytest.mark.parametrize("fn,passes", [(BN.batch_norm_plain, True), (_zero_below_half, False),
                                       (_zeros, False)], ids=["plain", "kink_at_half", "zeros"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_the_card_check_holds_the_relu_to_the_plain_pre_activation(fn, passes, train):
    """The check takes the ReLU's mask from the plain ops' own float32
    pre-activation: a norm that zeroes y (and so dy) where ``0 < z <= 0.5``,
    or writes zeros, fails it in train and in eval mode."""
    gen = torch.Generator().manual_seed(11)
    x = _x(gen, (8, 24, 14, 14), torch.bfloat16, "channels_last")
    g = torch.randn(x.shape, generator=gen).to(torch.bfloat16)
    params = [torch.randn(24, generator=gen) * 0.5 + 1.0, torch.randn(24, generator=gen) * 0.5,
              torch.randn(24, generator=gen) * 0.1, torch.rand(24, generator=gen) + 0.5]
    z = BN.batch_norm_plain(x.float(), params[0], params[1], params[2].clone(),
                            params[3].clone(), train, 0.9, 1e-5, False)
    want = _run_norm(BN.batch_norm_plain, x, g, params, train)
    got = _run_norm(fn, x, g, params, train)
    if passes:
        errs = chip_smoke.check_relu_norm("stem norm", got, want, z)
        assert set(errs) == ({"y", "running", "dx", "dw_db"} if train else {"y"})
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_relu_norm("stem norm", got, want, z)


def test_relu_kink_refuses_a_crowded_kink():
    """More than ``KINK_SHARE`` of the pre-activation within a few ulps of 0
    would forgive too much dx: the check raises."""
    z = torch.randn(4, 3, 10, 10, generator=torch.Generator().manual_seed(0))
    assert not chip_smoke.relu_kink("z", z).any()
    z[0, 0, 0, 0] = 0.0
    with pytest.raises(AssertionError, match="within 8 ulps"):
        chip_smoke.relu_kink("z", z)
