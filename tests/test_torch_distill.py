"""Knowledge distillation's parts of the port against the JAX package.

- ``distillation_loss``, hard and soft, within 1e-6;
- the RegNetY teacher at narrow widths, weights carried by
  ``vit_search_torch.convert``, eval logits within 1e-4 of the largest
  logit in float32; the RegNetY-16GF structure of ``regnety_160_upsample``
  against the JAX module's parameter shapes, both ways through convert;
- ``resize_images`` (``RegNetYUpsample``'s resize) against
  ``jax.image.resize(..., "bicubic")``, shrinking and growing;
- the flat ViT and DeiT names: the registry's names against the JAX
  package's, and each net's forward (distill token where the name has one)
  at one or two blocks against the JAX model, within 1e-4.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.models import regnet as jax_regnet
from vit_search_tpu.models import registry as jax_registry
from vit_search_tpu.train import losses as jax_losses
from vit_search_torch.convert import (from_jax, load_jax, regnet_from_jax, regnet_to_jax,
                                      to_jax)
from vit_search_torch.models import (RegNetY, RegNetYUpsample, available_models,
                                     create_model, resize_images)
from vit_search_torch.train import distillation_loss

REPO = pathlib.Path(__file__).resolve().parent.parent
# narrow RegNetY: two stages, the second two blocks (a block without the
# projection shortcut), groups of 8 channels
NARROW = dict(widths=(16, 32), depths=(1, 2), group_width=8, stem_width=8, num_classes=10)


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distillation_loss_matches_jax(hard, dtype):
    rng = np.random.default_rng(0)
    s = rng.normal(size=(16, 10)).astype(np.float32) * 3
    t = rng.normal(size=(16, 10)).astype(np.float32) * 3
    want = jax_losses.distillation_loss(jnp.asarray(s).astype(dtype), jnp.asarray(t).astype(dtype),
                                        hard=hard, temperature=2.5)
    got = distillation_loss(torch.tensor(s).to(getattr(torch, dtype)),
                            torch.tensor(t).to(getattr(torch, dtype)), hard, 2.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_soft_distillation_is_cross_entropy_not_kl():
    """The soft loss is the teacher's cross-entropy times T^2: it exceeds
    ``F.kl_div`` by the teacher's entropy."""
    rng = np.random.default_rng(1)
    s, t = (torch.tensor(rng.normal(size=(8, 6)).astype(np.float32)) for _ in range(2))
    temp = 3.0
    p = torch.softmax(t / temp, -1)
    kl = torch.nn.functional.kl_div(torch.log_softmax(s / temp, -1), p,
                                    reduction="batchmean") * temp ** 2
    entropy = -(p * p.log()).sum(-1).mean() * temp ** 2
    np.testing.assert_allclose(float(distillation_loss(s, t, False, temp)),
                               float(kl + entropy), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_narrow(seed=0, img=32):
    """A narrow JAX RegNetY, its variables with random BN statistics (jitted
    init and apply: eager flax takes seconds per call on the CPU)."""
    net = jax_regnet.RegNetY(**NARROW)
    variables = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                         .astype(np.float32), variables["batch_stats"])
    return (jax.jit(net.apply), {"regnet": jax.tree.map(np.asarray, variables["params"])},
            {"regnet": stats})


@pytest.mark.parametrize("img", [32, 40])
def test_regnety_matches_jax(img):
    apply, params, stats = _jax_narrow()
    x = np.random.default_rng(2).normal(size=(4, img, img, 3)).astype(np.float32)
    want = np.asarray(apply({"params": params["regnet"], "batch_stats": stats["regnet"]},
                            jnp.asarray(x)))
    model = RegNetY(**NARROW, device="cpu", seed=5)
    load_jax(model, params, stats)
    model.eval()
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_regnet_convert_round_trip():
    _, params, stats = _jax_narrow()
    sd = regnet_from_jax(params, stats)
    assert "s2.b2.conv1.conv.weight" in sd and "s2.b2.downsample.conv.weight" not in sd
    assert sd["s2.b1.conv2.conv.weight"].shape == (32, 8, 3, 3)      # 4 groups of 8
    back_params, back_stats = regnet_to_jax(sd)
    for tree, back in ((params, back_params), (stats, back_stats)):
        assert jax.tree.structure(tree) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
    ema, empty = regnet_to_jax(regnet_from_jax(params, None))
    assert empty == {} and jax.tree.structure(ema) == jax.tree.structure(params)


def test_regnety_160_upsample_has_the_16gf_structure():
    """``regnety_160_upsample``'s parameters and statistics, carried to the
    JAX tree, have exactly the JAX module's names and shapes (84M
    parameters: stage widths 224/448/1232/3024, depths 2/4/11/1, groups of
    112, squeeze-excite on the block's input width x 0.25)."""
    shapes = jax.eval_shape(jax_regnet.RegNetYUpsample().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    model = create_model("regnety_160_upsample", device="cpu")
    assert isinstance(model, RegNetYUpsample) and model.target_size == 224
    params, stats = regnet_to_jax(model.state_dict())
    for tree, want in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
        got = jax.tree.map(lambda a: tuple(a.shape), tree)
        assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert model.s3.b1.se.fc1.weight.shape == (112, 1232, 1, 1)   # 448 * 0.25


@pytest.mark.parametrize("src,dst", [(40, 24), (20, 32)], ids=["shrink", "grow"])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(src).normal(size=(2, src, src + 4, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method="bicubic"))
    got = resize_images(torch.tensor(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("img", [48, 24], ids=["shrink", "grow"])
def test_regnety_upsample_matches_jax(img):
    """RegNetYUpsample at a 32 px target and narrow widths against the JAX
    module's forward (``jax.image.resize`` then RegNetY)."""
    apply, params, stats = _jax_narrow()
    x = np.random.default_rng(img).normal(size=(2, img, img, 3)).astype(np.float32)
    resized = jax.image.resize(jnp.asarray(x), (2, 32, 32, 3), method="bicubic")
    want = np.asarray(apply({"params": params["regnet"], "batch_stats": stats["regnet"]},
                            resized))
    model = RegNetYUpsample(target_size=32, **NARROW, device="cpu")
    load_jax(model, params, stats)
    model.eval()
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _jax_registered_names():
    """The names vit_search_tpu/models/registry.py registers, read from its
    source (the JAX registry itself may hold test models)."""
    tree = ast.parse((REPO / "vit_search_tpu/models/registry.py").read_text())
    return sorted(f.name for f in tree.body if isinstance(f, ast.FunctionDef)
                  and any(getattr(d, "id", None) == "register_model" for d in f.decorator_list))


# names the port registers beyond the JAX package's (models it has no
# counterpart of)
PORT_ONLY = ["eva02_large_patch14_448", "swinv2_base_window16_256"]


def test_registry_names_match_jax():
    assert available_models() == sorted(_jax_registered_names() + PORT_ONLY)
    assert len(available_models()) == 23


SR_DEF = ((0, 16), (1, (16, 2, 8), (16, 32), 1), (3, 16, 32), (1, (32, 2, 16), (32, 64), 1),
          (2, 32, 10))


def _small_kwargs(name):
    """Narrow arguments for a registered name, its default resolution kept."""
    if name.startswith("flexible_vit_sr"):
        return dict(network_def=SR_DEF)
    if name.startswith("flexible_vit"):
        return dict(network_def=FLAT_DEF)
    if name.startswith("deit"):
        return dict(depth=1, num_classes=10)
    if name.startswith("swinv2"):
        return dict(img_size=64, embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
                    window_size=4, num_classes=10)
    if name.startswith("eva02"):
        return dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
    return dict(NARROW)


@pytest.mark.parametrize("name", available_models())
def test_every_registered_name_builds_and_runs_on_the_cpu(name):
    """``create_model`` builds every registered name (narrow, at its default
    resolution) on the CPU, and its eval forward gives finite logits for
    each head: the distill token on the DeiT ``distill`` names and every
    flat ViT, none on the stock DeiT names."""
    model = create_model(name, device="cpu", **_small_kwargs(name)).eval()
    size = model.target_size if isinstance(model, RegNetYUpsample) else model.img_size
    with torch.no_grad():
        out = model(torch.zeros(1, size, size, 3))
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.shape == (1, 10) and torch.isfinite(o).all() for o in outs)
    if name.startswith(("deit", "flexible_vit_patch16")):
        assert model.patch_embed.proj.stride == (16, 16)
        assert len(outs) == 2 if "distill" in name or name.startswith("flexible") else 1


FLAT_DEF = ((0, 48), (1, (48, 3, 16), (48, 96), 1), (1, (48, 3, 16), (48, 96), 1),
            (2, 48, 10))
# name -> keyword arguments at a small size: the flexible names take a
# network_def (two blocks), the DeiT names their own widths at one block
FLAT_NAMES = {**{n: dict(network_def=FLAT_DEF) for n in
                 ("flexible_vit_patch16_224", "flexible_vit_patch16_224_supernet",
                  "flexible_vit_patch16_192", "flexible_vit_patch16_192_supernet")},
              **{n: dict(depth=1, num_classes=10) for n in
                 ("deit_tiny_patch16_224", "deit_small_patch16_224", "deit_base_patch16_224",
                  "deit_tiny_distill_patch16_224", "deit_tiny_133X_distill_patch16_224",
                  "deit_tiny_167X_distill_patch16_224", "deit_small_distill_patch16_224")}}


@pytest.mark.parametrize("name", sorted(FLAT_NAMES))
def test_flat_vit_and_deit_forward_matches_jax(name):
    kwargs = dict(FLAT_NAMES[name], img_size=32)
    jmodel = jax_registry.create_model(name, **kwargs)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    model = create_model(name, device="cpu", **kwargs)
    assert model.network_def == jmodel.network_def and model.patch_embed.proj.stride == (16, 16)
    load_jax(model, params, {})
    # convert carries the flat net both ways
    back, _ = to_jax(from_jax(params, None, model.network_def), model.network_def)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    model.eval()
    with torch.no_grad():
        got = model(torch.tensor(x))
    distill = "distill" in name or name.startswith("flexible")
    assert isinstance(got, tuple) == distill == isinstance(want, tuple)
    for g, w in zip(got if distill else (got,), want if distill else (want,)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
