"""One full train step of the port against the JAX package's step.

The small conv-stem supernet of test_torch_model (56px, three stages) trains
one step with token mixup, stochastic depth 0.1 and AdamW on both sides from
the same weights, images, labels and packed keep counts. The random draws are
the JAX step's own: the token-mixup permutations, box and mixing weight are
rebuilt from the keys the JAX step derives (engine.py:95-96, mixup.py), and
the stochastic-depth keeps are fixed arrays that both sides take (the JAX
``_drop_path`` is replaced for the test, since flax derives its per-module
keys internally). ``tests/test_torch_distributed.py`` holds the same step,
run in two processes, to this reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.data import mixup as jax_mixup
from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.models import layers as jax_layers
from vit_search_tpu.models.supernet import SupernetSchedules as JaxSchedules
from vit_search_tpu.models.supernet import build_arch_masks as jax_build_arch_masks
from vit_search_tpu.train import OptimConfig as JaxOptimConfig
from vit_search_tpu.train import TrainConfig as JaxTrainConfig
from vit_search_tpu.train import TrainState
from vit_search_tpu.train import cosine_schedule as jax_schedule
from vit_search_tpu.train import engine as jax_engine
from vit_search_tpu.train import losses as jax_losses
from vit_search_tpu.train import make_optimizer as jax_make_optimizer
from vit_search_tpu.train import make_train_step as jax_make_train_step
from vit_search_torch.convert import from_jax, load_jax
from vit_search_torch.data.mixup import ImageMixDraws, PatchMixDraws, TokenMixDraws
from vit_search_torch.models import VisionTransformerSR
from vit_search_torch.train import OptimConfig, StepDraws, TrainConfig

from test_torch_distributed import port_step
from test_torch_model import NET, SPACE

BATCH, IMG, PATCH_LEN, CLASSES, DPR = 8, 56, 2, 10, 0.1


def _jax_token_mix_draws(k_mix, batch, grid):
    """The draws switch_token_mix makes from ``k_mix`` (mixup.py:62-115)."""
    half = batch // 2
    k1, k2 = jax.random.split(k_mix)
    k_perm, k_lam, k_box = jax.random.split(k1, 3)
    perm1 = np.asarray(jax.random.permutation(k_perm, half))
    y0, x0, h, w, _ = jax_mixup._rand_box(k_box, grid, jax.random.beta(k_lam, 1.0, 1.0))
    k_perm2, k_lam2 = jax.random.split(k2)
    perm2 = np.asarray(jax.random.permutation(k_perm2, batch - half))
    lam2 = float(jax.random.beta(k_lam2, 0.8, 0.8))
    return TokenMixDraws(PatchMixDraws(perm1, int(y0), int(x0), int(h), int(w)),
                         ImageMixDraws(perm2, lam2))


def fixed_keeps():
    """The stochastic-depth keeps both sides take, in call order (attn, mlp, ...)."""
    rng = np.random.default_rng(7)
    keeps = [rng.random(BATCH) < 1.0 - DPR for _ in range(6)]
    keeps[0][:2] = False        # make sure some branches are dropped
    return keeps


def _take_keeps(monkeypatch, keeps):
    """Make the JAX blocks take ``keeps``, in call order (attn, mlp, ...)."""
    calls = [0]

    def drop_path(x, rate, key, deterministic):
        keep = jnp.asarray(keeps[calls[0] % len(keeps)])
        calls[0] += 1
        keep = keep.reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))

    monkeypatch.setattr(jax_layers, "_drop_path", drop_path)


@pytest.fixture
def fixed_drop_path(monkeypatch):
    """Make the JAX blocks take :func:`fixed_keeps`; returns them."""
    keeps = fixed_keeps()
    _take_keeps(monkeypatch, keeps)
    return keeps


def jax_reference_step(monkeypatch):
    """The JAX step on the seeded batch, its JAX blocks made to take
    :func:`fixed_keeps`; and the port's model, config and draws for the
    same step. Returns a dict."""
    keeps = fixed_keeps()
    _take_keeps(monkeypatch, keeps)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, BATCH)

    # --- JAX: the step, and its gradients from the same loss
    jmodel = JaxViT(network_def=NET, img_size=IMG, patch_size=14, num_classes=CLASSES,
                    patch_output=True, drop_path_rate=DPR)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    jsched = JaxSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    counts = jsched.sample_packed(np.random.default_rng(1), BATCH)
    jocfg = JaxOptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH)
    tx = jax_make_optimizer(jocfg, params)
    jtcfg = JaxTrainConfig(num_classes=CLASSES, mixup_mode="token", patch_len=PATCH_LEN)
    jstep = jax_make_train_step(jmodel, tx, jtcfg, schedule=jax_schedule(jocfg),
                                donate=False, counts_unpack=jsched.unpack)
    key = jax.random.PRNGKey(42)
    new_state, jmetrics = jstep(TrainState.create(params, tx, stats), jnp.asarray(images),
                                jnp.asarray(labels), jnp.asarray(counts), key)

    k_mix, k_drop, k_path, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    x = jax_engine._normalize(jnp.asarray(images), jtcfg)
    masks = jax_build_arch_masks(jsched.unpack(jnp.asarray(counts), BATCH), NET, BATCH)
    images_m, targets, patch_targets = jax_mixup.switch_token_mix(
        k_mix, x, jnp.asarray(labels), PATCH_LEN, CLASSES, 0.1)

    def loss_fn(p):
        (cls, patch), _ = jmodel.apply({"params": p, "batch_stats": stats}, images_m, masks,
                                       deterministic=False, patch_output_type="seq",
                                       rngs={"dropout": k_drop, "drop_path": k_path},
                                       mutable=["batch_stats"])
        return (jax_losses.soft_target_cross_entropy(cls, targets)
                + jax_losses.soft_target_cross_entropy(patch, patch_targets))

    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))

    # --- the port's side: the same weights and draws
    model = VisionTransformerSR(NET, img_size=IMG, patch_size=14, num_classes=CLASSES,
                                patch_output=True, drop_path_rate=DPR, device="cpu")
    load_jax(model, params, stats)
    return {
        "images": images, "labels": labels, "counts": counts,
        "model_kwargs": dict(network_def=NET, img_size=IMG, patch_size=14,
                             num_classes=CLASSES, patch_output=True, drop_path_rate=DPR),
        "state_dict": model.state_dict(),
        "ocfg": OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH),
        "tcfg": TrainConfig(num_classes=CLASSES, mixup_mode="token", patch_len=PATCH_LEN),
        "space": SPACE,
        "draws": StepDraws(mix=_jax_token_mix_draws(k_mix, BATCH, PATCH_LEN),
                           drop_keeps=[torch.tensor(k) for k in keeps]),
        "metrics": {k: float(v) for k, v in jmetrics.items()},
        "grads": from_jax(jgrads, stats, NET),
        "state": from_jax(jax.tree.map(np.asarray, new_state.params),
                          jax.tree.map(np.asarray, new_state.batch_stats), NET),
    }


def assert_step_matches_jax(ref, metrics, grads, state):
    """The port's step (its metrics, each parameter's gradient as numpy and
    the state dict after the step) against :func:`jax_reference_step`'s."""
    jmetrics = ref["metrics"]
    np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jmetrics["grad_norm"], rtol=1e-5)
    assert metrics["lr"] == pytest.approx(jmetrics["lr"], rel=1e-7)

    want_grads = ref["grads"]
    for name, got in grads.items():
        g = want_grads[name]
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-5 * np.abs(g).max() + 1e-9,
                                   err_msg=name)

    # AdamW's first step moves each parameter by lr * g / (|g| + eps), about
    # lr: hold it to 1e-6. Where |g| is near eps = 1e-8 the direction is
    # rounding noise on either side, so there the step may differ by 2 * lr.
    want = ref["state"]
    assert sorted(state) == sorted(want)
    lr = jmetrics["lr"]
    for name, v in want.items():
        tol = np.full(v.shape, 1e-6, np.float32)
        if name in grads:
            tol[np.abs(want_grads[name]) < 1e-7] = 2 * lr + 1e-6
        err = np.abs(state[name].numpy() - v)
        assert (err <= tol).all(), f"{name}: max err {err.max():.3g}"


def test_train_step_matches_jax(monkeypatch):
    ref = jax_reference_step(monkeypatch)
    model, step = port_step(ref)
    metrics = step(torch.tensor(ref["images"]), torch.tensor(ref["labels"]), ref["counts"],
                   draws=ref["draws"])
    assert_step_matches_jax(ref, metrics,
                            {n: p.grad.numpy() for n, p in model.named_parameters()},
                            model.state_dict())
