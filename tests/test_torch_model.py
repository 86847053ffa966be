"""The port's masked ViT-SR forward against the JAX model, same weights.

Weights go from the JAX model to the port through ``vit_search_torch.convert``;
masks come from the same packed keep counts. The JAX model runs its fused
attention through the Pallas kernels in interpret mode; the port runs on CPU
tensors, i.e. through the plain versions of its kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.models.supernet import SupernetSchedules as JaxSchedules
from vit_search_tpu.models.supernet import build_arch_masks as jax_build_arch_masks
from vit_search_torch.convert import load_jax
from vit_search_torch.models import (SupernetSchedules, VisionTransformerSR,
                                     build_arch_masks)

# conv stem, three stages (widths 32/64/128) at 56px, patch 14: N = 17/5/2
NET = ((4, 32),
       (1, (32, 2, 16), (32, 64), 1),
       (1, (32, 2, 16), (32, 64), 1),
       (3, 32, 64),
       (1, (64, 4, 16), (64, 128), 1),
       (3, 64, 128),
       (1, (128, 4, 32), (128, 256), 1),
       (2, 128, 10))
SPACE = [np.array([32, 24]),
         {"attn": np.array([32, 16]), "mlp": np.array([64, 48]), "layer": None},
         {"attn": np.array([32, 16]), "mlp": np.array([64, 48]), "layer": np.array([32, 0])},
         np.array([64, 48]),
         {"attn": np.array([64, 32]), "mlp": np.array([128, 96]), "layer": None},
         np.array([128, 96]),
         {"attn": np.array([128, 64]), "mlp": np.array([256, 192]), "layer": None},
         None]
# linear stem with a bypass (removed) slot at 28px, patch 7: N = 17/5
BYPASS_NET = ((0, 16),
              (1, (16, 2, 8), (16, 32), 1),
              (1, (16, 2, 8), (16, 32), 0),
              (3, 16, 32),
              (1, (32, 2, 16), (32, 64), 1),
              (2, 32, 10))
BYPASS_SPACE = [np.array([16, 8]),
                {"attn": np.array([16, 8]), "mlp": np.array([32, 16]), "layer": None},
                {"attn": np.array([16, 8]), "mlp": np.array([32, 16]), "layer": None},
                np.array([32, 16]),
                {"attn": np.array([32, 16]), "mlp": np.array([64, 32]), "layer": None},
                None]
CASES = {"conv_stem_3_stage": (NET, SPACE, 56, 14), "linear_stem_bypass": (BYPASS_NET,
                                                                           BYPASS_SPACE, 28, 7)}
BATCH = 8


def build(case, gelu="exact"):
    net, space, img, patch = CASES[case]
    jmodel = JaxViT(network_def=net, img_size=img, patch_size=patch, num_classes=10,
                    patch_output=True)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, img, img, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    model = VisionTransformerSR(net, img_size=img, patch_size=patch, num_classes=10,
                                patch_output=True, gelu=gelu, device="cpu")
    load_jax(model, params, stats)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, img, img, 3)).astype(np.float32)
    counts = JaxSchedules(net, space, example_per_arch=2,
                          num_warmup_epochs=0).sample_packed(rng, BATCH)
    return jmodel, params, stats, model, x, counts


def _masks(case, counts):
    net, space, _, _ = CASES[case]
    jax_masks = jax_build_arch_masks(
        JaxSchedules(net, space, 2, 0).unpack(jnp.asarray(counts), BATCH), net, BATCH)
    masks = build_arch_masks(SupernetSchedules(net, space, 2, 0).unpack(counts, BATCH),
                             net, BATCH)
    return jax_masks, masks


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_train_forward_matches_jax(case):
    jmodel, params, stats, model, x, counts = build(case)
    jax_masks, masks = _masks(case, counts)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    key = jax.random.PRNGKey(3)
    (cls_ref, patch_ref), new_vars = jmodel.apply(
        variables, jnp.asarray(x), jax_masks, deterministic=False, patch_output_type="seq",
        rngs={"dropout": key, "drop_path": key}, mutable=["batch_stats"])
    model.train()
    cls, patch = model(torch.tensor(x), masks, patch_output_type="seq")
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(cls_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(patch.detach().numpy(), np.asarray(patch_ref),
                               rtol=1e-4, atol=1e-4)
    if stats:   # flax BN: momentum 0.9, biased batch variance
        for c in ("conv1", "conv2", "conv3"):
            bn = new_vars["batch_stats"]["patch_embed"][c]["bn"]
            mod = getattr(model.patch_embed, c).bn
            np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(bn["mean"]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(bn["var"]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax(case, masked):
    jmodel, params, stats, model, x, counts = build(case)
    jax_masks, masks = _masks(case, counts) if masked else (None, None)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    ref = jmodel.apply(variables, jnp.asarray(x), jax_masks, deterministic=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.tensor(x), masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_tanh_gelu_is_an_explicit_argument(monkeypatch):
    """The JAX model reads VST_GELU at trace time; the port takes ``gelu``."""
    monkeypatch.setenv("VST_GELU", "tanh")
    jmodel, params, stats, model, x, counts = build("linear_stem_bypass", gelu="tanh")
    ref = jmodel.apply({"params": params}, jnp.asarray(x), None, deterministic=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "dense"])
def test_distill_supernet_forward_matches_jax(masked):
    """A distill-token supernet: two-row ``tokens`` and the ``dst_head`` go
    through ``convert``; both heads' logits match."""
    net, space, img, patch = CASES["conv_stem_3_stage"]
    jmodel = JaxViT(network_def=net, img_size=img, patch_size=patch, num_classes=10,
                    distill_token=True)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(4), jnp.zeros((2, img, img, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    assert params["tokens"].shape == (1, 2, 32) and "dst_head" in params
    model = VisionTransformerSR(net, img_size=img, patch_size=patch, num_classes=10,
                                distill_token=True, device="cpu")
    load_jax(model, params, stats)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BATCH, img, img, 3)).astype(np.float32)
    counts = JaxSchedules(net, space, example_per_arch=2,
                          num_warmup_epochs=0).sample_packed(rng, BATCH)
    jax_masks, masks = _masks("conv_stem_3_stage", counts) if masked else (None, None)
    cls_ref, dst_ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                    jax_masks, deterministic=True)
    model.eval()
    with torch.no_grad():
        cls, dst = model(torch.tensor(x), masks)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dst.numpy(), np.asarray(dst_ref), rtol=1e-4, atol=1e-4)
    assert not np.allclose(np.asarray(cls_ref), np.asarray(dst_ref))
