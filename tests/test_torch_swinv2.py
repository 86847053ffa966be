"""SwinV2 in the port (``models/swin_v2.py``, ``ops/window_attention.py``)
on the CPU, against the plain float32 reference ``tests/swinv2_reference.py``.

The net is SwinV2 cut to img 64, patch 4, embed 32, depths 2 / 2 / 2 / 2,
heads 1 / 2 / 4 / 8 (head dim 32), window 4: stage 1 is 16 windows with a
shift, stage 2 four windows with a shift, stage 3 one whole-stage window,
stage 4 a window clipped to its 2 x 2 grid. Weights are drawn from a seed,
the norms near 1 (not Swin's zero res-post-norm init, under which every
block starts as the identity and the attention's gradients vanish).
"""

import ast
import math
import os

import numpy as np
import pytest
import torch

import swinv2_reference as R
from vit_search_torch import models, train
from vit_search_torch.models import registry, swin_v2
from vit_search_torch.ops.window_attention import region_mask, window_attention_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"img_size": 64, "patch_size": 4, "embed_dim": 32, "depths": (2, 2, 2, 2),
         "num_heads": (1, 2, 4, 8), "window_size": 4, "mlp_ratio": 4.0}
CLASSES = 10
DROP_PATH = 0.2
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small models run no faster on more, and
    beside the suite's other workers more threads only contend (a full
    tier-1 run read this file up to 40x slower on the default count)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def small_model(**kw):
    return models.create_model(
        "swinv2_base_window16_256", img_size=64, embed_dim=32, depths=(2, 2, 2, 2),
        num_heads=(1, 2, 4, 8), window_size=4, num_classes=kw.pop("num_classes", CLASSES),
        device="cpu", **kw)


def seeded(model, seed=0):
    """Weights from ``seed``: norms near 1, ``logit_scale`` near ln 10 with
    one head of each stage's second block past the clamp, the bias MLP at
    its fan-in scale, the rest at 0.1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("logit_scale"):
                p.copy_(math.log(10.0) + 0.3 * noise)
                if ".blocks.1." in name:
                    p[0] = math.log(100.0) + 0.5      # clamped: no gradient
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            elif "cpb_mlp" in name:
                p.copy_(noise / math.sqrt(p.shape[-1]))
            else:
                p.copy_(0.1 * noise)
    return model


@pytest.fixture(scope="module")
def pair():
    model = seeded(small_model(drop_path_rate=DROP_PATH))
    params = {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(BATCH, 64, 64, 3, generator=gen)
    keeps = [torch.rand(BATCH, generator=gen) < 1.0 - r
             for r in R.drop_path_draws(SMALL["depths"], DROP_PATH)]
    targets = torch.softmax(torch.randn(BATCH, CLASSES, generator=gen), -1)
    model.train()
    logits = model(images, drop_keeps=keeps)
    loss = train.losses.soft_target_cross_entropy(logits, targets)
    loss.backward()
    ref_logits = R.forward(params, images, SMALL, keeps, DROP_PATH)
    ref_loss = -(targets * torch.log_softmax(ref_logits, -1)).sum(-1).mean()
    grads = torch.autograd.grad(ref_loss, list(params.values()))
    return model, logits, loss, ref_logits, ref_loss, dict(zip(params, grads))


# both sides are float32 on the CPU and differ only in the order of their
# sums (the port normalises inside the attention op, the reference around
# explicit (nW, N, N) masks): 1e-5 of the largest logit, 1e-5 relative loss
def test_logits_and_loss_match_the_reference(pair):
    _, logits, loss, ref_logits, ref_loss, _ = pair
    assert logits.shape == (BATCH, CLASSES)
    assert (logits - ref_logits).abs().max() <= 1e-5 * ref_logits.abs().max()
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)


def test_every_gradient_matches_the_reference(pair):
    """Every leaf, within 1e-3 of its own largest entry. Both sides are
    float32 (the op's plain path computes in float32 whatever its input),
    summed in other orders; the attention's scale of 10 to 100 multiplies
    each score's rounding into the softmax's gradient, which reads up to
    1.6e-4 of a leaf at this seed (4.6e-5 with every norm and the loss in
    float64, where the op's float32 is all that is left)."""
    model, *_, ref_grads = pair
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(ref_grads)
    for name, p in named.items():
        ref = ref_grads[name]
        assert p.grad is not None, name
        assert (p.grad - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-12, name


def test_the_gradients_reach_the_new_leaves(pair):
    """``logit_scale`` below the clamp, ``cpb_mlp``, ``q_bias`` and ``v_bias``
    get gradients; a head past the clamp gets none, on both sides."""
    model, *_, ref_grads = pair
    named = dict(model.named_parameters())
    for stem in ("layers.0.blocks.1.attn", "layers.1.blocks.1.attn", "layers.2.blocks.1.attn"):
        g, ref = named[stem + ".logit_scale"].grad.view(-1), ref_grads[stem + ".logit_scale"]
        assert g[0] == 0 and ref.view(-1)[0] == 0
        if g.numel() > 1:
            assert g[1:].abs().min() > 0
        for leaf in ("cpb_mlp.0.weight", "cpb_mlp.0.bias", "cpb_mlp.2.weight", "q_bias",
                     "v_bias"):
            assert named[f"{stem}.{leaf}"].grad.abs().max() > 0, leaf
    assert named["layers.0.blocks.0.attn.logit_scale"].grad.abs().min() > 0


def test_state_dict_names_follow_swin():
    names = set(dict(small_model().named_parameters()))
    for name in ("patch_embed.proj.weight", "patch_embed.norm.bias",
                 "layers.0.blocks.1.attn.cpb_mlp.0.weight",
                 "layers.0.blocks.1.attn.cpb_mlp.2.weight", "layers.2.blocks.0.attn.logit_scale",
                 "layers.1.blocks.0.attn.q_bias", "layers.1.blocks.0.attn.v_bias",
                 "layers.3.blocks.1.attn.qkv.weight", "layers.0.downsample.reduction.weight",
                 "layers.2.downsample.norm.weight", "norm.weight", "head.bias"):
        assert name in names, name
    assert "layers.3.downsample.reduction.weight" not in names
    assert "layers.0.blocks.0.attn.qkv.bias" not in names


def test_published_init_and_weight_decay_groups():
    model = small_model()
    named = dict(model.named_parameters())
    assert float(named["layers.0.blocks.0.norm1.weight"].detach().abs().max()) == 0.0
    assert torch.allclose(named["layers.1.blocks.1.attn.logit_scale"],
                          torch.full((2, 1, 1), math.log(10.0)))
    decay, no_decay = train.optim.weight_decay_groups(model)
    ids = {id(p) for p in no_decay}
    for name, p in named.items():
        skipped = p.ndim == 1 or "cpb_mlp" in name or "logit_scale" in name
        assert (id(p) in ids) == skipped, name


def test_relative_index_by_hand():
    index = swin_v2.relative_position_index(2)
    # tokens (0,0) (0,1) (1,0) (1,1); entry = (dy + 1) * 3 + (dx + 1)
    assert index.tolist() == [[4, 3, 1, 0], [5, 4, 2, 1], [7, 6, 4, 3], [8, 7, 5, 4]]
    assert torch.equal(index, R.position_index(2))


def test_log_spaced_table_by_hand():
    table = swin_v2.relative_coords_table(16)
    assert table.shape == (31, 31, 2)
    corner = math.log2(9.0) / 3.0            # offset 15 -> 8 -> log2(9) / log2(8)
    one = math.log2(1.0 + 8.0 / 15.0) / 3.0  # offset 1 -> 8 / 15
    assert table[0, 0].tolist() == pytest.approx([-corner, -corner], rel=1e-6)
    assert table[15, 16].tolist() == pytest.approx([0.0, one], rel=1e-6)
    assert table[30, 15].tolist() == pytest.approx([corner, 0.0], rel=1e-6)
    assert torch.equal(table, R.coords_table(16)[0])


def test_shift_mask_by_hand():
    regions = swin_v2.shift_regions(8, 4, 2)
    assert regions.shape == (4, 16) and regions.dtype == torch.int32
    assert regions[0].tolist() == [0] * 16
    assert regions[3].tolist() == [4, 4, 5, 5, 4, 4, 5, 5, 7, 7, 8, 8, 7, 7, 8, 8]
    mask = region_mask(regions)
    assert mask[3, 0, 15] == -100.0 and mask[3, 0, 1] == 0.0 and mask[3, 0, 4] == 0.0
    assert torch.equal(mask, R.attn_mask(8, 4, 2))


def test_plain_attention_equals_the_explicit_form():
    """The op's plain function on shifted windows with a bias, against the
    reference's explicit masks and bias, float32."""
    gen = torch.Generator().manual_seed(3)
    heads, n = 2, 16
    qkv = torch.randn(8, n, 3 * heads * 32, generator=gen)
    scale = torch.tensor([10.0, 3.0])
    bias = 16 * torch.sigmoid(torch.randn(heads, n, n, generator=gen))
    regions = swin_v2.shift_regions(8, 4, 2)
    got = window_attention_plain(qkv, scale, bias, regions, heads)
    q, k, v = qkv.view(8, n, 3, heads, 32).permute(2, 0, 3, 1, 4)
    s = (torch.nn.functional.normalize(q, dim=-1)
         @ torch.nn.functional.normalize(k, dim=-1).transpose(-2, -1))
    s = (s * scale.view(1, heads, 1, 1) + bias).view(2, 4, heads, n, n)
    s = (s + R.attn_mask(8, 4, 2)[None, :, None]).view(8, heads, n, n)
    want = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(8, n, heads * 32)
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.parametrize("shifted", [False, True])
def test_rounded_plain_attention_rounds_only_the_normalised_q_and_k(shifted):
    """``rounded=True`` (the kernels' comparison) rounds q' = scale q / |q|
    and k' = k / |k| to bf16 and passes the gradient straight through:
    where q' and k' are bf16 already (one-hot rows, a bf16 scale) it is the
    unrounded function, forward and every gradient, to float32's last bits
    (the two forms apply the scale before and after ``q' k'^T``); at a scale
    of 100 on random rows the rounding moves the output."""
    gen = torch.Generator().manual_seed(5)
    heads, n, bw = 2, 16, 8
    regions = swin_v2.shift_regions(8, 4, 2) if shifted else None
    bias = 16 * torch.sigmoid(torch.randn(heads, n, n, generator=gen))
    g = torch.randn(bw, n, heads * 32, generator=gen)
    hot = torch.nn.functional.one_hot(torch.randint(0, 32, (bw, n, 2 * heads), generator=gen),
                                      32).float() * 3.0
    v = torch.randn(bw, n, heads * 32, generator=gen)
    exact = torch.cat([hot.view(bw, n, -1), v], -1)

    def run(qkv, scale, rounded):
        leaves = [qkv.clone().requires_grad_(), scale.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        out = window_attention_plain(*leaves, regions, heads, rounded=rounded)
        return (out,) + torch.autograd.grad(out, leaves, g)

    scale = torch.tensor([10.0, 0.75])
    for a, b in zip(run(exact, scale, True), run(exact, scale, False)):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    qkv = torch.randn(bw, n, 3 * heads * 32, generator=gen)
    scale = torch.tensor([100.0, 100.0])
    got, want = run(qkv, scale, True), run(qkv, scale, False)
    assert not torch.equal(got[0], want[0])
    # a bf16 q' or k' holds 8 bits: at scale 100 a score moves by up to about 0.4
    assert (got[0] - want[0]).abs().max() <= 0.5 * want[0].abs().max()


def test_registered_and_refuses_what_it_does_not_take():
    assert "swinv2_base_window16_256" in models.available_models()
    with pytest.raises(ValueError):
        models.create_model("swinv2_base_window16_256", network_def=((4, 24),), device="cpu")
    with pytest.raises(NotImplementedError):
        small_model(dropout_rate=0.1)
    model = small_model()
    with pytest.raises(ValueError):
        model(torch.zeros(1, 64, 64, 3), masks={"embed": None})


def test_train_step_with_mixup_and_erasing():
    """The engine's train step (Mixup/CutMix, erasing, clipping) runs the
    model and moves every leaf but the one-head ``logit_scale`` held past
    the clamp, which has no gradient and no weight decay."""
    model = seeded(small_model(drop_path_rate=DROP_PATH))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ocfg = train.OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, clip_grad=5.0,
                             global_batch_size=BATCH)
    tcfg = train.TrainConfig(num_classes=CLASSES, mixup_mode="mixup", erasing_prob=0.25)
    step = train.make_train_step(model, train.make_optimizer(ocfg, model), tcfg,
                                 schedule=train.lr_schedule(ocfg), seed=0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (BATCH, 64, 64, 3), dtype=torch.uint8, generator=gen)
    out = step(images, torch.randint(0, CLASSES, (BATCH,), generator=gen))
    assert np.isfinite(float(out["loss"])) and float(out["grad_norm"]) > 0
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert sorted(set(before) - set(moved)) == ["layers.0.blocks.1.attn.logit_scale"]


def _definitions(path):
    return [ast.dump(node) for node in ast.parse(open(path).read()).body]


def test_benchmark_copy_is_the_reference_statement_for_statement():
    ours = _definitions(os.path.join(REPO, "tests", "swinv2_reference.py"))
    copy = _definitions(os.path.join(REPO, "benchmark", "reference", "swinv2.py"))
    assert ours == copy


# --- the CLI -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    from vit_search_torch.tools.make_synthfolder import generate

    root = str(tmp_path_factory.mktemp("swin_folder"))
    generate(root, num_classes=4, train_per_class=4, val_per_class=2, size=72, seed=0)
    return root


@pytest.fixture
def small_registered(monkeypatch):
    def swinv2_small_64(**kw):
        kw.setdefault("drop_path_rate", 0.5)
        return swin_v2.SwinTransformerV2(embed_dim=32, depths=(2, 2, 2, 2),
                                         num_heads=(1, 2, 4, 8), window_size=4, **kw)

    monkeypatch.setitem(registry._REGISTRY, "swinv2_small_64", swinv2_small_64)
    return "swinv2_small_64"


def _cli_args(folder, model, out, extra=()):
    from vit_search_torch.cli.train import get_args_parser

    return get_args_parser().parse_args(
        ["--data-path", folder, "--model", model, "--input-size", "64", "--batch-size", "8",
         "--val-bs", "8", "--epochs", "300", "--max-steps-per-epoch", "1", "--num_workers", "0",
         "--no-repeated-aug", "--no-bf16", "--warmup-epochs", "20", "--lr", "5e-4",
         "--warmup-lr", "1e-6", "--min-lr", "1e-5", "--weight-decay", "0.05",
         "--clip-grad", "5.0", "--mixup", "0.8", "--cutmix", "1.0",
         "--mixup-switch-prob", "0.5", "--smoothing", "0.1", "--reprob", "0.25",
         "--drop-path", "0.5", "--no-model-ema", "--device", "cpu", "--seed", "0",
         "--output_dir", out, *extra])


def test_cli_trains_checkpoints_resumes_and_evaluates(folder, small_registered, tmp_path):
    from vit_search_torch.cli import train as train_cli

    out = str(tmp_path / "run")
    first = train_cli.main(_cli_args(folder, small_registered, out, ["--epochs", "1"]))
    assert np.isfinite(first["train_loss"])
    raw = train.restore_raw(os.path.join(out, "checkpoints", "checkpoint"))
    assert raw["step"] == 1 and "layers.0.blocks.1.attn.cpb_mlp.0.weight" in raw["params"]
    resumed = train_cli.main(_cli_args(folder, small_registered, out,
                                       ["--epochs", "2", "--resume", "auto"]))
    assert resumed["epoch"] == 1
    assert train.restore_raw(os.path.join(out, "checkpoints", "checkpoint"))["step"] == 2
    evaluated = train_cli.main(_cli_args(folder, small_registered, out,
                                         ["--resume", "auto", "--eval"]))
    assert 0.0 <= evaluated["eval"]["acc1"] <= 100.0
