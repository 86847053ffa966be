"""EVA-02 in the port (``models/eva02.py``, ``ops/rope_attention.py``,
``ops/swiglu_ln.py``, layer-wise learning-rate decay) on the CPU, against
the plain float32 reference ``tests/eva02_reference.py``.

A tiny EVA-02: 56 px, patch 14 (N = 17), C 64, 2 heads of 32, depth 2,
hidden ``int(64 * 8 / 3)`` = 170, which is 2 modulo 4 as 2730 is.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_search_torch import models, train
from vit_search_torch.models import eva02, registry
from vit_search_torch.ops import rope_attention as R
from vit_search_torch.ops import swiglu_ln as S

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import eva02_reference as REF  # noqa: E402

TINY = dict(img_size=56, embed_dim=64, depth=2, num_heads=2, num_classes=10)
CFG = dict(img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=2)
RATE = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small models run no faster on more, and
    beside the suite's other workers more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny(**kw):
    return models.create_model("eva02_large_patch14_448", device="cpu", seed=0,
                               drop_path_rate=RATE, **{**TINY, **kw})


def seeded(model, seed=0):
    """Random weights away from the init (layer-norm scales near 1, every
    bias and the position table moved), so that every leaf's gradient
    counts."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            one = p.ndim == 1 and name.endswith("weight")
            p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if one else 0.05) + float(one))
    return {n: p.detach().clone().requires_grad_() for n, p in model.named_parameters()}


def test_logits_and_gradients_match_the_reference():
    """Training mode with drop path's keeps handed in: the port's float32
    logits within 1e-5 of the reference's (the same function in another
    order: one stacked q/k/v GEMM, the rotation by columns, the plain layer
    norm); each leaf's gradient of the soft-target loss within 1e-5 of its
    norm (the same rounding summed through the backward: about 6e-7)."""
    model = tiny()
    P = seeded(model)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(3, 56, 56, 3, generator=gen)
    keeps = [torch.tensor([True, False, True]), torch.tensor([False, True, True])]
    targets = torch.softmax(torch.randn(3, 10, generator=gen), -1)
    logits = model(images, drop_keeps=keeps)
    ref = REF.forward(P, images, CFG, keeps, RATE)
    assert float((logits - ref).detach().abs().max()) <= 1e-5
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(REF.soft_ce(logits, targets), list(model.parameters()))
    want = torch.autograd.grad(REF.soft_ce(ref, targets), [P[n] for n in names])
    for name, g, w in zip(names, got, want):
        assert float(w.norm()) > 0, name
        assert float((g - w).norm()) <= 1e-5 * float(w.norm()), name


def test_rope_tables_at_448_px_are_the_closed_form():
    """Row 0 (the cls token) the identity; patch token ``1 + 32 i + j`` at
    column ``c``: ``cos(t * theta^(-2 floor(c' / 2) / 32))`` with ``t = i / 2``
    for the first 32 columns (``c' = c``), ``j / 2`` for the last
    (``c' = c - 32``), in float64 within float32's rounding of an angle up
    to 15.5 rad (2e-6); equal to the reference's tables."""
    cos, sin = eva02.rope_tables(32, 64)
    assert cos.shape == sin.shape == (1025, 64)
    assert torch.equal(cos[0], torch.ones(64)) and torch.equal(sin[0], torch.zeros(64))
    i, j = np.divmod(np.arange(1024), 32)
    c = np.arange(64)
    t = np.where(c[None, :] < 32, i[:, None], j[:, None]) / 32 * 16
    angle = t * 10000.0 ** (-2 * ((c % 32) // 2) / 32)[None, :]
    assert np.abs(cos[1:].double().numpy() - np.cos(angle)).max() < 2e-6
    assert np.abs(sin[1:].double().numpy() - np.sin(angle)).max() < 2e-6
    rc, rs = REF.rope_freqs(64, 32)
    assert torch.equal(cos[1:], rc) and torch.equal(sin[1:], rs)


def _reference_attention(qkv, heads, rope):
    """The reference's ops on a packed projection: q, k, v by head, the
    rotation of the patch rows with the cls row put back, softmax attention."""
    b, n, w3 = qkv.shape
    q, k, v = (t.reshape(b, n, heads, -1).permute(0, 2, 1, 3) for t in qkv.chunk(3, -1))
    if rope is not None:
        cos, sin = rope
        q = torch.cat((q[:, :, :1], q[:, :, 1:] * cos + REF.rotate_half(q[:, :, 1:]) * sin), -2)
        k = torch.cat((k[:, :, :1], k[:, :, 1:] * cos + REF.rotate_half(k[:, :, 1:]) * sin), -2)
    s = (q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1)
    out = (s.softmax(-1) @ v).transpose(1, 2).reshape(b, n, -1)
    return out, torch.logsumexp(s, -1)


@pytest.mark.parametrize("rope", [True, False], ids=["tables", "no_tables"])
def test_rope_attention_plain_versions_match_the_reference(rope):
    """R1's plain version (output and log-sum-exp) and R2's (the packed
    cotangent, dq and dk rotated back) against the reference's ops and
    their autograd, float32, within 1e-6 of the largest entry (the same
    function in another order)."""
    gen = torch.Generator().manual_seed(2)
    qkv = torch.randn(2, 17, 3 * 2 * 32, generator=gen, requires_grad=True)
    g = torch.randn(2, 17, 2 * 32, generator=gen)
    tables = eva02.rope_tables(4, 32) if rope else None
    ref, lse = _reference_attention(qkv, 2, REF.rope_freqs(32, 4) if rope else None)
    (want,) = torch.autograd.grad(ref, qkv, g)
    out, got_lse = R.rope_attention_plain(qkv.detach(), tables, 32 ** -0.5, 2)
    got = R.rope_attention_bwd_plain(qkv.detach(), g, tables, 32 ** -0.5, 2)
    for a, b in ((out, ref), (got_lse, lse), (got, want)):
        assert float((a - b).detach().abs().max()) <= 1e-6 * float(b.detach().abs().max())


@pytest.mark.parametrize("hidden", [170, 171])
def test_swiglu_ln_plain_versions_match_the_reference(hidden):
    """G1's plain version against ``layer_norm(silu(a) * b)`` of the
    reference's ops; G2's (the packed cotangent, the norm's weight and bias
    gradients) against their autograd, float32, within 1e-5 of the largest
    entry (the backward's closed form against autograd's order)."""
    gen = torch.Generator().manual_seed(hidden)
    u = (2 * torch.randn(5, 7, 2 * hidden, generator=gen)).requires_grad_()
    w = (1 + 0.1 * torch.randn(hidden, generator=gen)).requires_grad_()
    b = (0.1 * torch.randn(hidden, generator=gen)).requires_grad_()
    g = torch.randn(5, 7, hidden, generator=gen)
    x1, x2 = u.chunk(2, -1)
    ref = F.layer_norm(F.silu(x1) * x2, (hidden,), w, b, REF.LN_EPS)
    want = torch.autograd.grad(ref, (u, w, b), g)
    y = S.swiglu_ln_plain(u.detach(), w.detach(), b.detach(), REF.LN_EPS)
    stats = S.swiglu_ln_stats_plain(u.detach(), REF.LN_EPS, hidden)
    got = S.swiglu_ln_bwd_plain(u.detach(), w.detach(), stats, g)
    for a, e in ((y, ref), *zip(got, want)):
        assert float((a - e).detach().abs().max()) <= 1e-5 * float(e.detach().abs().max())


def test_state_dict_keys_are_eva02s():
    per_block = ["norm1.weight", "norm1.bias", "attn.q_proj.weight", "attn.k_proj.weight",
                 "attn.v_proj.weight", "attn.q_bias", "attn.v_bias",
                 "attn.inner_attn_ln.weight", "attn.inner_attn_ln.bias", "attn.proj.weight",
                 "attn.proj.bias", "norm2.weight", "norm2.bias", "mlp.w1.weight",
                 "mlp.w1.bias", "mlp.w2.weight", "mlp.w2.bias", "mlp.ffn_ln.weight",
                 "mlp.ffn_ln.bias", "mlp.w3.weight", "mlp.w3.bias"]
    want = {"patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token", "pos_embed",
            "fc_norm.weight", "fc_norm.bias", "head.weight", "head.bias"}
    want |= {f"blocks.{i}.{k}" for i in range(2) for k in per_block}
    model = tiny()
    assert set(model.state_dict()) == want
    assert model.hidden == 170
    assert model.blocks[0].mlp.w1.weight.shape == (170, 64)


def test_layer_decay_groups_scale_each_layer():
    """Block ``i`` at ``0.85 ** (depth - i)``, the stem, ``cls_token`` and
    ``pos_embed`` at ``0.85 ** (depth + 1)``, ``fc_norm`` and the head at 1;
    weight decay on rank > 1 leaves but ``pos_embed`` and ``cls_token``; the
    train step sets each group's rate to the schedule's times its scale."""
    model = tiny()
    cfg = train.OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, layer_decay=0.85)
    opt = train.make_optimizer(cfg, model)
    names = {id(p): n for n, p in model.named_parameters()}
    seen = set()
    for group in opt.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            seen.add(name)
            if name.startswith(("patch_embed", "cls_token", "pos_embed")):
                power = 3
            elif name.startswith("blocks."):
                power = 2 - int(name.split(".")[1])
            else:
                power = 0
            assert group["lr_scale"] == pytest.approx(0.85 ** power, rel=1e-12), name
            decays = p.ndim > 1 and name not in ("pos_embed", "cls_token")
            assert group["weight_decay"] == (0.05 if decays else 0.0), name
    assert seen == set(names.values())
    step = train.make_train_step(model, opt, train.TrainConfig(num_classes=10),
                                 schedule=train.lr_schedule(cfg), device="cpu")
    step(torch.zeros(2, 56, 56, 3, dtype=torch.uint8), torch.tensor([0, 1]))
    for group in opt.param_groups:
        assert group["lr"] == pytest.approx(cfg.scaled_lr * group["lr_scale"], rel=1e-6)


NETS = {
    "deit_tiny_patch16_224": dict(depth=1),
    "flexible_vit_sr_patch14_224": dict(network_def=((0, 16), (1, (16, 2, 8), (16, 32), 1),
                                                     (2, 16, 4)), img_size=28),
    "swinv2_base_window16_256": dict(img_size=64, embed_dim=32, depths=(2, 2, 2, 2),
                                     num_heads=(1, 2, 4, 8), window_size=4),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_existing_nets_keep_their_two_groups_with_the_flag_off(name):
    """Off, the optimizer's groups are the decayed and the not-decayed
    leaves of ``weight_decay_groups``, with no scale; on, a net that numbers
    no layers is refused."""
    model = models.create_model(name, device="cpu", **NETS[name])
    decay, no_decay = train.weight_decay_groups(model)
    groups = train.make_optimizer(train.OptimConfig(clip_grad=5.0), model).param_groups
    assert [[id(p) for p in g["params"]] for g in groups] == [[id(p) for p in decay],
                                                              [id(p) for p in no_decay]]
    assert [g["weight_decay"] for g in groups] == [0.05, 0.0]
    assert all("lr_scale" not in g and g["clip_grad"] == 5.0 for g in groups)
    with pytest.raises(ValueError, match="layer_decay"):
        train.make_optimizer(train.OptimConfig(layer_decay=0.85), model)


# --- the CLI -----------------------------------------------------------------------

@pytest.fixture
def tiny_registered(monkeypatch):
    def eva02_tiny_56(**kw):
        kw["img_size"] = 56
        return eva02.EVA02(patch_size=14, embed_dim=64, depth=2, num_heads=2, **kw)

    monkeypatch.setitem(registry._REGISTRY, "eva02_tiny_56", eva02_tiny_56)
    return "eva02_tiny_56"


def test_cli_trains_with_layer_decay(tiny_registered, tmp_path):
    from vit_search_torch.cli import train as train_cli
    from vit_search_torch.tools.make_synthfolder import generate

    folder = str(tmp_path / "data")
    generate(folder, num_classes=4, train_per_class=2, val_per_class=1, size=64, seed=0)
    args = train_cli.get_args_parser().parse_args(
        ["--data-path", folder, "--model", tiny_registered, "--input-size", "56",
         "--batch-size", "4", "--val-bs", "4", "--epochs", "1", "--max-steps-per-epoch", "1",
         "--num_workers", "0", "--no-repeated-aug", "--no-bf16", "--layer_decay", "0.85",
         "--drop-path", "0.15", "--mixup", "0.8", "--cutmix", "1.0", "--smoothing", "0.1",
         "--reprob", "0.25", "--model-ema", "--model-ema-decay", "0.9999",
         "--device", "cpu", "--seed", "0", "--output_dir", str(tmp_path / "run")])
    result = train_cli.main(args)
    assert math.isfinite(result["train_loss"])
