"""Supernet masks and drop path as per-example keep counts (``ops/prefix_mask.py``).

On the CPU: the counts tree of ``build_arch_masks`` against its boolean masks;
a small supernet's forward and backward on the count route (the plain
versions of M1-M3, the route forced) against the boolean multiplies; the CUDA
wrappers refuse CPU tensors; each record counts one per launch. Marked
``gpu``: M1, M2 and M3 against their plain versions and the boolean
composition on the card, and one Tiny and one Medium train step against the
boolean route. This file imports nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_prefix_mask.py
"""

import types

import numpy as np
import pytest
import torch

from vit_search_torch.arch import network_def as nd
from vit_search_torch.arch import presets, spaces
from vit_search_torch.models import SupernetSchedules, build_arch_masks, create_model
from vit_search_torch.models import layers
from vit_search_torch.ops import prefix_mask as pm
from vit_search_torch.ops.drop_path import drop_path
from vit_search_torch.ops.masking import make_channel_mask

# a two-stage supernet at 56 px with a linear stem: slot 1 has a layer site,
# slot 2 none, slot 3 one again (the chain across a block without a layer site)
NET = ((0, 32),
       (1, (32, 2, 16), (32, 64), 1), (1, (32, 2, 16), (32, 64), 1),
       (1, (32, 2, 16), (32, 64), 1),
       (3, 32, 48),
       (1, (48, 2, 24), (48, 96), 1),
       (2, 48, 10))
SPACE = [np.array([32, 24]),
         {"attn": np.array([32, 16]), "mlp": np.array([64, 40]), "layer": np.array([32, 0])},
         {"attn": np.array([32, 16]), "mlp": np.array([64, 24]), "layer": None},
         {"attn": np.array([32, 16]), "mlp": np.array([64, 48]), "layer": np.array([32, 0])},
         np.array([48, 40]),
         {"attn": np.array([48, 24]), "mlp": np.array([96, 56]), "layer": None},
         None]
BATCH = 8


def _counts(seed: int):
    sched = SupernetSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    return sched.unpack(sched.sample_packed(np.random.default_rng(seed), BATCH), BATCH)


def _site_widths(slot):
    block = NET[slot]
    if nd.block_type(block) == nd.SPATIAL_REDUCTION:
        return {"embed": nd.sr_channels(block)[1]}
    t = nd.transformer_def(block)
    return {"attn": t.attn_width, "mlp": t.ffn_hidden, "layer": t.embed_dim}


def test_counts_tree_equals_each_masks_row_sums():
    """Every site's int32 counts are its boolean mask's row sums, for a
    sampled tree and for candidates that remove a block (layer count 0)."""
    sched = SupernetSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    removed = [list(NET), list(NET)]
    removed[1][1] = (1, (32, 2, 16), (32, 64), 0)
    chosen = sched.counts_for_subnets(removed)
    assert chosen["slots"][1]["layer"].tolist() == [32, 0]
    for counts in (_counts(0), chosen):
        masks = build_arch_masks(counts, NET, BATCH)
        tree = masks["counts"]
        assert torch.equal(tree["embed"], masks["embed"].sum(-1).view(-1).int())
        for slot, site in masks["slots"].items():
            assert site.keys() == tree["slots"][slot].keys()
            for key, mask in site.items():
                n = tree["slots"][slot][key]
                assert n.dtype == torch.int32 and n.shape == (BATCH,)
                assert mask.shape == (BATCH, 1, _site_widths(slot)[key])
                assert torch.equal(n, mask.sum(-1).view(-1).int()), (slot, key)
        if counts is chosen:
            assert tree["slots"][1]["layer"].tolist() == [32, 0] * (BATCH // 2)


def test_kernel_route_builds_boolean_masks_only_for_the_layer_norms(monkeypatch):
    monkeypatch.setattr(pm, "kernel_route", lambda t: True)
    masks = build_arch_masks(_counts(1), NET, BATCH)
    assert masks["embed"] is not None
    assert sorted(masks["slots"]) == [4] and list(masks["slots"][4]) == ["embed"]
    assert sorted(masks["counts"]["slots"]) == [1, 2, 3, 4, 5]


def _run(model, x, masks, keeps):
    logits = model(x, masks, drop_keeps=keeps)
    logits.float().square().sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    return logits.detach(), grads


@pytest.mark.parametrize("gelu", ["exact", "tanh"])
def test_count_route_matches_the_boolean_route(monkeypatch, gelu):
    """The small supernet's forward and backward in float32, drop path 0.3
    with injected keeps, on the count route (M1-M3's plain versions, the
    route forced on CPU tensors) and on the boolean multiplies: the logits
    and every gradient agree to float32 rounding (drop path's divide becomes a
    multiply by the scale)."""
    model = create_model("flexible_vit_sr_patch14_224_supernet", network_def=NET, img_size=56,
                         num_classes=10, drop_path_rate=0.3, gelu=gelu, device="cpu", seed=0)
    model.train()
    x = torch.randn(BATCH, 56, 56, 3, generator=torch.Generator().manual_seed(2))
    counts = _counts(3)
    keeps = [torch.as_tensor(np.random.default_rng(4).random(BATCH) < 0.7) for _ in range(8)]
    want, want_grads = _run(model, x, build_arch_masks(counts, NET, BATCH), keeps)
    monkeypatch.setattr(pm, "kernel_route", lambda t: True)
    masks = build_arch_masks(counts, NET, BATCH)
    got, got_grads = _run(model, x, masks, keeps)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for name, g in want_grads.items():
        torch.testing.assert_close(got_grads[name], g, rtol=1e-4, atol=1e-6, msg=name)
    assert not all(k.all() for k in keeps) and any(
        (masks["counts"]["slots"][s]["layer"] == 0).any() for s in (1, 3))


def test_the_chain_across_a_block_without_a_layer_site(monkeypatch):
    """The count route's chain is the row sums of the boolean route's:
    min(own layer, incoming, embed) at a layer site, the embed count alone
    at a block without one (which drops the incoming layer count)."""
    model = create_model("flexible_vit_sr_patch14_224_supernet", network_def=NET, img_size=56,
                         num_classes=10, device="cpu", seed=0).eval()
    counts = _counts(5)
    bool_masks = build_arch_masks(counts, NET, BATCH)
    monkeypatch.setattr(pm, "kernel_route", lambda t: True)
    count_masks = build_arch_masks(counts, NET, BATCH)
    x = torch.randn(BATCH, 17, 32, generator=torch.Generator().manual_seed(6))
    x = x * bool_masks["embed"]
    chain_mask = chain_count = None
    for slot in (1, 2, 3):
        block = model.blocks[slot - 1]
        monkeypatch.setattr(pm, "kernel_route", lambda t: False)
        y_mask, chain_mask = block(x, bool_masks["embed"], chain_mask, bool_masks["slots"][slot])
        monkeypatch.setattr(pm, "kernel_route", lambda t: True)
        y_count, chain_count = block(x, count_masks["embed"], chain_count, None, counts=(
            count_masks["counts"]["slots"][slot]), embed_count=count_masks["counts"]["embed"])
        torch.testing.assert_close(y_count, y_mask)
        assert torch.equal(chain_count, chain_mask.sum(-1).view(-1).int()), slot
    site = count_masks["counts"]["slots"]
    assert torch.equal(chain_count, torch.minimum(site[3]["layer"],
                                                  count_masks["counts"]["embed"]))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 3, 8, dtype=torch.bfloat16)
    n = torch.full((2,), 4, dtype=torch.int32)
    for call in (lambda: pm.prefix_gelu_fwd_cuda(x, n, "exact"),
                 lambda: pm.prefix_gelu_bwd_cuda(x, x, n, "tanh"),
                 lambda: pm.branch_add_cuda(x, x, n, None),
                 lambda: pm.prefix_scale_cuda(x, n, None)):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            call()


def test_each_record_counts_one_per_launch(monkeypatch):
    """Through the autograd functions with the library faked: M1's forward
    and backward once each, M2 once and M3 once for its backward, M3 once
    each way for the head mask."""
    def ok(*args):
        return 0

    fake = types.SimpleNamespace(vst_prefix_gelu_fwd=ok, vst_prefix_gelu_bwd=ok,
                                 vst_branch_add=ok, vst_prefix_scale=ok)
    monkeypatch.setattr(pm, "_lib", lambda: fake)
    monkeypatch.setattr(pm, "_check", lambda counts, scale, **t: (6, 3, 8, 1, None, None))
    monkeypatch.setattr(pm.kernels, "stream_ptr", lambda t: 0)
    records = (pm.GELU_FWD, pm.GELU_BWD, pm.BRANCH_ADD, pm.SCALE)

    def launched(fn):
        before = [r.launches for r in records]
        fn()
        return [r.launches - b for r, b in zip(records, before)]

    h = torch.zeros(2, 3, 8, requires_grad=True)
    n, s = torch.full((2,), 4, dtype=torch.int32), torch.ones(2)
    assert launched(lambda: pm._PrefixGelu.apply(h, n, "exact").sum().backward()) == [1, 1, 0, 0]
    x = torch.zeros(2, 3, 8, requires_grad=True)
    assert launched(lambda: pm._BranchAdd.apply(x, h, n, s).sum().backward()) == [0, 0, 1, 1]
    assert launched(lambda: pm._PrefixScale.apply(h, n, None).sum().backward()) == [0, 0, 0, 2]


# --- on the card -------------------------------------------------------------------

# (B, N, C) of the table's stages: Tiny's three (the embed width; M1 at the
# hidden width) and Medium's stage 1, at a small batch
CARD_SHAPES = [(6, 257, 256, 768), (6, 65, 512, 1536), (6, 17, 1024, 3072), (6, 257, 240, 960)]
CARD_IDS = ["tiny1", "tiny2", "tiny3", "medium1"]
KEEPS = {"all_dropped": [False] * 6, "all_kept": [True] * 6,
         "mixed": [True, False, True, True, False, True]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_counts(c: int, cuda) -> torch.Tensor:
    """Counts of 0, partial (off a 16-byte vector's edge) and the full width."""
    return torch.tensor([0, c // 2 + 3, c, 8, c - 1, c // 3], dtype=torch.int32, device=cuda)


def _bitwise_close(got, want, dtype):
    """Within one rounding of the output type: the kernels round once from
    float32, as the plain versions do. Their float32 GELU is PyTorch's
    formula, whose erf, tanh and exp may differ by an ulp; their bf16 exact
    GELU takes erfc(|z|) for 1 + erf(z) of a negative z (``csrc/
    prefix_mask.cu``), where float32's 1 + erf(z) loses its digits: the
    deep negative tail, below a millionth of the largest value, is held to
    that floor."""
    tol = {torch.bfloat16: 8e-3, torch.float32: 2e-6}[dtype]
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol * want.abs() + 1e-6 * want.abs().max()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden", CARD_SHAPES, ids=CARD_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("gelu", ["exact", "tanh"])
def test_prefix_gelu_matches_plain(cuda, b, n, c, hidden, dtype, gelu):
    gen = torch.Generator(device=cuda).manual_seed(hidden)
    h = (torch.randn(b, n, hidden, device=cuda, generator=gen) * 2).to(dtype)
    g = torch.randn(b, n, hidden, device=cuda, generator=gen).to(dtype)
    counts = _card_counts(hidden, cuda)
    before = (pm.GELU_FWD.launches, pm.GELU_BWD.launches)
    leaf = h.clone().requires_grad_()
    y = pm.prefix_gelu(leaf, counts, gelu)
    (dh,) = torch.autograd.grad(y, leaf, g)
    torch.cuda.synchronize()
    assert (pm.GELU_FWD.launches, pm.GELU_BWD.launches) == (before[0] + 1, before[1] + 1)
    ref = h.clone().requires_grad_()
    want = pm.prefix_gelu_plain(ref, counts, gelu)
    (want_dh,) = torch.autograd.grad(want, ref, g)
    assert _bitwise_close(y, want, dtype) and _bitwise_close(dh, want_dh, dtype)
    # the boolean composition: F.gelu, then the mask multiply
    mask = make_channel_mask(counts, hidden)
    old = layers.apply_mask(torch.nn.functional.gelu(
        h, approximate="tanh" if gelu == "tanh" else "none"), mask)
    torch.testing.assert_close(y, old, rtol=2e-2, atol=2e-2)
    assert (y[0] == 0).all() and (dh[0] == 0).all()
    # a planted off-by-one count must fail
    planted = pm.prefix_gelu_fwd_cuda(h, counts + 1, gelu)
    assert not _bitwise_close(planted, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden", CARD_SHAPES, ids=CARD_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("keeps", sorted(KEEPS))
def test_branch_add_matches_plain(cuda, b, n, c, hidden, dtype, keeps):
    """M2 forward and backward (M3 for f, g itself for x) against the plain
    version, and against drop path, the mask multiply and the add."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(b, n, c, device=cuda, generator=gen).to(dtype)
    f = torch.randn(b, n, c, device=cuda, generator=gen).to(dtype)
    g = torch.randn(b, n, c, device=cuda, generator=gen).to(dtype)
    counts = _card_counts(c, cuda)
    keep = torch.tensor(KEEPS[keeps], device=cuda)
    scale = pm.drop_path_scale(b, 0.3, cuda, keep)
    before = (pm.BRANCH_ADD.launches, pm.SCALE.launches)
    lx, lf = x.clone().requires_grad_(), f.clone().requires_grad_()
    out = pm.branch_add(lx, lf, counts, scale)
    dx, df = torch.autograd.grad(out, (lx, lf), g)
    torch.cuda.synchronize()
    assert (pm.BRANCH_ADD.launches, pm.SCALE.launches) == (before[0] + 1, before[1] + 1)
    rx, rf = x.clone().requires_grad_(), f.clone().requires_grad_()
    want = pm.branch_add_plain(rx, rf, counts, scale)
    want_dx, want_df = torch.autograd.grad(want, (rx, rf), g)
    assert torch.equal(out, want) and torch.equal(dx, want_dx) and torch.equal(df, want_df)
    mask = make_channel_mask(counts, c)
    old = x + layers.apply_mask(drop_path(f, 0.3, True, keep=keep), mask)
    torch.testing.assert_close(out, old, rtol=2e-2, atol=2e-2)
    planted = pm.branch_add_cuda(x, f, counts + 1, scale)
    assert torch.equal(planted, want) == (keeps == "all_dropped")
    # no count, no scale: each alone
    assert torch.equal(pm.branch_add_cuda(x, f, None, scale),
                       pm.branch_add_plain(x, f, None, scale))
    assert torch.equal(pm.branch_add_cuda(x, f, counts, None),
                       pm.branch_add_plain(x, f, counts, None))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden", CARD_SHAPES, ids=CARD_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("keeps", sorted(KEEPS))
def test_prefix_scale_matches_plain(cuda, b, n, c, hidden, dtype, keeps):
    gen = torch.Generator(device=cuda).manual_seed(c + 1)
    y = torch.randn(b, n, c, device=cuda, generator=gen).to(dtype)
    g = torch.randn(b, n, c, device=cuda, generator=gen).to(dtype)
    counts = _card_counts(c, cuda)
    scale = pm.drop_path_scale(b, 0.25, cuda, torch.tensor(KEEPS[keeps], device=cuda))
    before = pm.SCALE.launches
    leaf = y.clone().requires_grad_()
    out = pm.prefix_scale(leaf, counts, scale)
    (dy,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    assert pm.SCALE.launches == before + 2
    assert torch.equal(out, pm.prefix_scale_plain(y, counts, scale))
    assert torch.equal(dy, pm.prefix_scale_plain(g, counts, scale))
    head = pm.prefix_scale_cuda(y, counts, None)
    assert torch.equal(head, layers.apply_mask(y, make_channel_mask(counts, c)))
    planted = pm.prefix_scale_cuda(y, counts + 1, None)
    assert not torch.equal(planted, head)


@pytest.mark.gpu
def test_kernels_take_odd_widths_and_misaligned_views(cuda):
    """C not a multiple of a 16-byte vector, and a view off 16 bytes, take
    the one-element path."""
    for c, offset in ((100, 0), (256, 2)):
        base = torch.randn(3 * 5 * c + offset, device=cuda).to(torch.bfloat16)
        x = base[offset:].view(3, 5, c)
        counts = torch.tensor([0, c // 2 + 1, c], dtype=torch.int32, device=cuda)
        scale = torch.tensor([1.25, 0.0, 1.25], device=cuda)
        assert torch.equal(pm.prefix_scale_cuda(x, counts, scale),
                           pm.prefix_scale_plain(x, counts, scale))
        assert torch.equal(pm.branch_add_cuda(x, x, counts, scale),
                           pm.branch_add_plain(x, x, counts, scale))
        assert _bitwise_close(pm.prefix_gelu_fwd_cuda(x, counts, "exact"),
                              pm.prefix_gelu_plain(x, counts, "exact"), torch.bfloat16)


def _steps(make, route: bool, monkeypatch, images, labels, counts):
    """One train step from the same weights and draws, with the count route
    on (``route``) or the boolean multiplies on the card."""
    from vit_search_torch.ops import kernels
    from vit_search_torch.train import StepDraws

    monkeypatch.setattr(pm, "kernel_route", lambda t: route and t.is_cuda)
    step, batch = make()
    rng = np.random.default_rng(0)
    draws = StepDraws(drop_keeps=[torch.as_tensor(rng.random(batch) < 0.8, device="cuda")
                                  for _ in range(2 * len(step.model.blocks))])
    kernels.reset_launches()
    metrics = step(images, labels, counts, draws=draws)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    params = {k: v.detach().float().clone() for k, v in step.model.named_parameters()}
    return float(metrics["loss"]), float(metrics["grad_norm"]), params, launches


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["tiny_supernet", "medium"])
def test_train_step_matches_the_boolean_route(cuda, monkeypatch, net):
    """One bf16 train step of the full-width Tiny supernet (drop path 0.2)
    and of the Medium net (drop path 0.3) at 64 images on the kernels'
    route, against the same step on the boolean multiplies: loss and
    gradient norm within bf16's rounding of the branch sums, and M1-M3's
    launches as ``chip_smoke.recipe_launches`` counts them."""
    import chip_smoke
    from vit_search_torch.arch import parse_network_def
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule, make_optimizer,
                                        make_train_step)

    batch = 64
    images, labels = chip_smoke.synthetic_batch(batch, 224, 0)
    if net == "tiny_supernet":
        sched = SupernetSchedules(presets.SUPERNET_SR_TINY_MH, spaces.get_space("sr_tiny_mh"),
                                  example_per_arch=4, num_warmup_epochs=0)
        counts = sched.sample_packed(np.random.default_rng(1), batch)
        network_def, masked, rate = presets.SUPERNET_SR_TINY_MH, True, 0.2

        def make():
            step, _ = chip_smoke.supernet_step(batch=batch, example_per_arch=4)
            return step, batch
    else:
        _, argv = chip_smoke.recipe_argv(chip_smoke.MEDIUM, "", 1)
        network_def = parse_network_def(argv[argv.index("--network-def") + 1])
        counts, masked, rate = None, False, 0.3

        def make():
            model = create_model("flexible_vit_sr_patch14_224_patch_output",
                                 network_def=network_def, dtype=torch.bfloat16,
                                 drop_path_rate=rate, gelu="exact", seed=0)
            ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=1,
                               global_batch_size=batch)
            return make_train_step(model, make_optimizer(ocfg, model),
                                   TrainConfig(num_classes=1000, mixup_mode="token",
                                               patch_len=4),
                                   schedule=lr_schedule(ocfg)), batch

    loss0, norm0, params0, _ = _steps(make, False, monkeypatch, images, labels, counts)
    loss1, norm1, params1, launches = _steps(make, True, monkeypatch, images, labels, counts)
    print(f"{net}: boolean route loss {loss0} grad norm {norm0}; kernels {loss1} {norm1}")
    assert abs(loss1 - loss0) <= 2e-3 * abs(loss0)
    assert abs(norm1 - norm0) <= 1e-2 * abs(norm0)
    per_step, _ = chip_smoke.recipe_launches(network_def, 224, masked, rate)
    for name in ("prefix_gelu_fwd", "prefix_gelu_bwd", "branch_add", "prefix_scale"):
        assert launches[name] == per_step[name], (name, launches[name], per_step[name])
    assert params1.keys() == params0.keys()
