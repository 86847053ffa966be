"""Pieces of the port's train step against the JAX package: token mixup with
the JAX draws, losses, the LR curve and the weight-decay mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.data import mixup as jax_mixup
from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.train import losses as jax_losses
from vit_search_tpu.train import optim as jax_optim
from vit_search_torch.convert import from_jax
from vit_search_torch.data import mixup
from vit_search_torch.models import VisionTransformerSR
from vit_search_torch.train import losses, optim

from test_torch_train_step import _jax_token_mix_draws


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_switch_token_mix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 56, 56, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8)
    key = jax.random.PRNGKey(seed)
    want = jax_mixup.switch_token_mix(key, jnp.asarray(x), jnp.asarray(labels), 4, 10, 0.1)
    draws = _jax_token_mix_draws(key, 8, 4)
    got = mixup.switch_token_mix(torch.tensor(x), torch.tensor(labels), 4, 10, 0.1,
                                 draws=draws)
    for g, w, name in zip(got, want, ("mixed", "targets", "patch_targets")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_sampled_token_mix_draws_are_valid():
    rng = np.random.default_rng(0)
    for _ in range(50):
        d = mixup.sample_token_mix_draws(rng, 16, 4)
        assert sorted(d.patch.perm) == list(range(8)) and sorted(d.image.perm) == list(range(8))
        assert 0 <= d.patch.y0 and d.patch.y0 + d.patch.h <= 4
        assert 0 <= d.patch.x0 and d.patch.x0 + d.patch.w <= 4
        assert 0.0 <= d.image.lam <= 1.0


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 5, 10)).astype(np.float32)
    targets = rng.dirichlet(np.ones(10), size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    np.testing.assert_allclose(
        float(losses.soft_target_cross_entropy(torch.tensor(logits), torch.tensor(targets))),
        float(jax_losses.soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(targets))),
        rtol=1e-6)
    flat = logits[:, 0]
    np.testing.assert_allclose(
        float(losses.cross_entropy(torch.tensor(flat), torch.tensor(labels))),
        float(jax_losses.cross_entropy(jnp.asarray(flat), jnp.asarray(labels))), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.label_smoothing_cross_entropy(torch.tensor(flat), torch.tensor(labels))),
        float(jax_losses.label_smoothing_cross_entropy(jnp.asarray(flat),
                                                        jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(sched="step", decay_epochs=7),
                                dict(sched="tanh"), dict(lr_noise=0.5, seed=3),
                                dict(lr_noise=(0.2, 0.6))],
                         ids=["cosine", "step", "tanh", "noise", "noise_window"])
def test_lr_curve_matches_jax(kw):
    common = dict(epochs=30, warmup_epochs=3, steps_per_epoch=4, global_batch_size=256)
    ours, theirs = optim.OptimConfig(**common, **kw), jax_optim.OptimConfig(**common, **kw)
    np.testing.assert_allclose(optim.timm_epoch_lrs(ours), jax_optim.timm_epoch_lrs(theirs),
                               rtol=1e-12)
    s_ours, s_theirs = optim.lr_schedule(ours), jax_optim.lr_schedule(theirs)
    for step in (0, 3, 4, 57, 119, 500):
        assert s_ours(step) == pytest.approx(float(s_theirs(step)), rel=1e-7)


def test_weight_decay_groups_match_jax_mask():
    net = ((4, 16), (1, (16, 2, 8), (16, 32), 1), (3, 16, 32),
           (1, (32, 2, 16), (32, 64), 1), (2, 32, 4))
    jmodel = JaxViT(network_def=net, img_size=28, patch_size=14, num_classes=4,
                    patch_output=True)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))
    params = variables["params"]
    mask = jax_optim.weight_decay_mask(params)
    decayed = jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32), params, mask)
    want = from_jax(decayed, jax.tree.map(np.asarray, variables["batch_stats"]), net)
    model = VisionTransformerSR(net, img_size=28, patch_size=14, num_classes=4,
                                patch_output=True, device="cpu")
    decay, no_decay = optim.weight_decay_groups(model)
    names = {id(p): n for n, p in model.named_parameters()}
    assert {names[id(p)] for p in decay} == {n for n in names.values() if want[n].max() == 1}
    assert {names[id(p)] for p in no_decay} == {n for n in names.values() if want[n].max() == 0}
    assert "pos_embed" in {names[id(p)] for p in decay}
    assert "tokens" in {names[id(p)] for p in no_decay}
