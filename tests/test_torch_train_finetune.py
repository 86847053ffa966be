"""The searched-net step and the finetune of the port against the JAX package.

The conv-stem net of test_torch_model (56 px, three stages) trains densely,
as ``searched_net/*.sh`` trains a searched winner, one step on both sides
from the same weights, images and labels: token mixup, stochastic depth,
random erasing (pixel, up to two regions, probability 0.5), gradient
clipping by global norm and an EMA. The draws are the JAX step's own
(token mixup and erasing rebuilt from its keys; the stochastic-depth keeps
fixed on both sides, see test_torch_train_step). Then each side finetunes
at 112 px as ``finetune/*.sh`` does: the EMA weights with every position
table resized (the port through a checkpoint and ``load_finetune``; the
tables within 1e-5 of the JAX package's), one more step from the JAX side's
weights, and eval logits of the parameters and of the EMA. Tolerances are
test_torch_train_step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.models import surgery as jax_surgery
from vit_search_tpu.train import OptimConfig as JaxOptimConfig
from vit_search_tpu.train import TrainConfig as JaxTrainConfig
from vit_search_tpu.train import TrainState
from vit_search_tpu.train import cosine_schedule as jax_schedule
from vit_search_tpu.train import engine as jax_engine
from vit_search_tpu.train import losses as jax_losses
from vit_search_tpu.train import make_optimizer as jax_make_optimizer
from vit_search_tpu.train import make_train_step as jax_make_train_step
from vit_search_tpu.data import erasing as jax_erasing
from vit_search_tpu.data import mixup as jax_mixup
from vit_search_torch.convert import from_jax, load_jax
from vit_search_torch.models import VisionTransformerSR
from vit_search_torch.train import (CheckpointManager, OptimConfig, StepDraws, TrainConfig,
                                    load_finetune, lr_schedule, make_eval_step,
                                    make_optimizer, make_train_step)

from test_torch_erasing import jax_erasing_draws
from test_torch_model import NET
from test_torch_train_step import _jax_token_mix_draws, fixed_drop_path  # noqa: F401

BATCH, CLASSES, DPR = 8, 10, 0.1
CLIP, EMA_DECAY = 0.5, 0.99
ERASING = dict(erasing_prob=0.5, erasing_mode="pixel", erasing_count=2)
# (image px, token-mixup grid): the searched net at 56 px, the finetune at 112
SEARCHED, FINETUNE = (56, 2), (112, 2)
STEM_CONVS = ("patch_embed.conv1.", "patch_embed.conv2.", "patch_embed.conv3.")


def _configs(patch_len, finetune=False):
    """The searched net's recipe at lr 1e-3; the finetune's as
    finetune/medium_img-size@392.sh sets it: lr 5e-6 (the global batch the
    LR scales by is 512), min lr 5e-6, weight decay 1e-8."""
    optim = dict(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH,
                 clip_grad=CLIP)
    if finetune:
        optim.update(base_lr=5e-6, min_lr=5e-6, weight_decay=1e-8, global_batch_size=512)
    jocfg = JaxOptimConfig(**optim)
    jtcfg = JaxTrainConfig(num_classes=CLASSES, mixup_mode="token", patch_len=patch_len,
                           ema_decay=EMA_DECAY, **ERASING)
    ocfg = OptimConfig(**optim)
    tcfg = TrainConfig(num_classes=CLASSES, mixup_mode="token", patch_len=patch_len,
                       ema_decay=EMA_DECAY, **ERASING)
    return jocfg, jtcfg, ocfg, tcfg


def _batch(seed, img):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, img, img, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, BATCH))


def _jax_step(jmodel, state, img, patch_len, seed, key, finetune=False):
    """One JAX step, its metrics, its unclipped gradients and the draws."""
    jocfg, jtcfg, _, _ = _configs(patch_len, finetune)
    tx = jax_make_optimizer(jocfg, state.params)
    step = jax_make_train_step(jmodel, tx, jtcfg, schedule=jax_schedule(jocfg), donate=False)
    images, labels = _batch(seed, img)
    new_state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels), None, key)

    k_mix, k_drop, k_path, k_erase = jax.random.split(jax.random.fold_in(key, state.step), 4)
    x = jax_engine._normalize(jnp.asarray(images), jtcfg)
    x = jax_erasing.random_erasing(k_erase, x, jtcfg.erasing_prob, mode=jtcfg.erasing_mode,
                                   count=jtcfg.erasing_count)
    images_m, targets, patch_targets = jax_mixup.switch_token_mix(
        k_mix, x, jnp.asarray(labels), patch_len, CLASSES, 0.1)
    stats = state.batch_stats

    def loss_fn(p):
        (cls, patch), _ = jmodel.apply({"params": p, "batch_stats": stats}, images_m, None,
                                       deterministic=False, patch_output_type="seq",
                                       rngs={"dropout": k_drop, "drop_path": k_path},
                                       mutable=["batch_stats"])
        return (jax_losses.soft_target_cross_entropy(cls, targets)
                + jax_losses.soft_target_cross_entropy(patch, patch_targets))

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(state.params))
    draws = dict(mix=_jax_token_mix_draws(k_mix, BATCH, patch_len),
                 erasing=jax_erasing_draws(k_erase, (BATCH, img, img, 3), jtcfg.erasing_prob,
                                           jtcfg.erasing_mode, jtcfg.erasing_count))
    return new_state, metrics, grads, draws, (images, labels)


def _check_step(step, metrics, jmetrics, jgrads, new_state, noisy=()):
    """Loss, norm and LR; clipped gradients; parameters, BN statistics and
    EMA after the step (AdamW's near-eps rule of test_torch_train_step).
    Parameters named in ``noisy`` have a JAX gradient that is itself off its
    float64 value by up to 1e-2 of its largest element (see
    ``test_jax_conv_stem_gradient_is_the_noisy_side``): their gradients are
    held to that, and AdamW's first step, lr times the gradient's sign, may
    differ by 2 lr wherever the sign is noise."""
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    norm = float(jmetrics["grad_norm"])
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-5)
    assert norm > CLIP, "the step must clip"
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-7)
    clipped = {k: v * (CLIP / norm) for k, v in from_jax(jgrads, None, NET).items()}
    for name, p in step.model.named_parameters():
        g = clipped[name]
        atol = (1e-2 if name in noisy else 1e-5) * np.abs(g).max() + 1e-9
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4, atol=atol, err_msg=name)
    lr = float(jmetrics["lr"])
    near_eps = {k: (np.abs(g) < 1e-7) | (k in noisy) for k, g in clipped.items()}
    want = from_jax(jax.tree.map(np.asarray, new_state.params),
                    jax.tree.map(np.asarray, new_state.batch_stats), NET)
    got = step.model.state_dict()
    assert sorted(got) == sorted(want)
    want_ema = from_jax(jax.tree.map(np.asarray, new_state.ema_params), None, NET)
    assert sorted(step.state.ema_params) == sorted(want_ema)
    for name, v in want.items():
        tol = np.full(v.shape, 1e-6, np.float32)
        if name in near_eps:
            tol[near_eps[name]] = 2 * lr + 1e-6
            err = np.abs(step.state.ema_params[name].numpy() - want_ema[name])
            assert (err <= tol * (1 - EMA_DECAY) + 1e-6).all(), f"EMA {name}: {err.max():.3g}"
        err = np.abs(got[name].numpy() - v)
        assert (err <= tol).all(), f"{name}: max err {err.max():.3g}"


def test_searched_step_and_finetune_match_jax(fixed_drop_path, tmp_path):
    keeps = [torch.tensor(k) for k in fixed_drop_path]

    # --- the searched net's dense step at 56 px
    img, patch_len = SEARCHED
    jmodel = JaxViT(network_def=NET, img_size=img, patch_size=14, num_classes=CLASSES,
                    patch_output=True, drop_path_rate=DPR)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, img, img, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    jocfg, _, ocfg, tcfg = _configs(patch_len)
    state = TrainState.create(params, jax_make_optimizer(jocfg, params), stats, use_ema=True)
    new_state, jmetrics, jgrads, draws, (images, labels) = _jax_step(
        jmodel, state, img, patch_len, 0, jax.random.PRNGKey(42))

    model = VisionTransformerSR(NET, img_size=img, patch_size=14, num_classes=CLASSES,
                                patch_output=True, drop_path_rate=DPR, device="cpu")
    load_jax(model, params, stats)
    step = make_train_step(model, make_optimizer(ocfg, model), tcfg,
                           schedule=lr_schedule(ocfg), device="cpu")
    metrics = step(torch.tensor(images), torch.tensor(labels),
                   draws=StepDraws(drop_keeps=keeps, **draws))
    assert draws["erasing"].apply.any() and draws["erasing"].fill is not None
    _check_step(step, metrics, jmetrics, jgrads, new_state)

    # --- the finetune at 112 px from the EMA weights
    img, patch_len = FINETUNE
    CheckpointManager(str(tmp_path)).save("best_ema", step, {"epoch": 0})
    jbig = JaxViT(network_def=NET, img_size=img, patch_size=14, num_classes=CLASSES,
                  patch_output=True, drop_path_rate=DPR)
    big_vars = jbig.init(jax.random.PRNGKey(1), jnp.zeros((2, img, img, 3)))
    big_params = jax_surgery.interpolate_pos_embeds(new_state.ema_params,
                                                    big_vars["params"], 1)
    big_params = jax.tree.map(np.asarray, big_params)
    big_stats = jax.tree.map(np.asarray, big_vars["batch_stats"])
    jocfg, _, ocfg, tcfg = _configs(patch_len, finetune=True)
    big_state = TrainState.create(big_params, jax_make_optimizer(jocfg, big_params),
                                  big_stats, use_ema=True)
    fine_state, jmetrics, jgrads, draws, (images, labels) = _jax_step(
        jbig, big_state, img, patch_len, 1, jax.random.PRNGKey(7), finetune=True)

    big = VisionTransformerSR(NET, img_size=img, patch_size=14, num_classes=CLASSES,
                              patch_output=True, drop_path_rate=DPR, device="cpu", seed=5)
    load_finetune(big, str(tmp_path / "best_ema"))
    for name, v in from_jax(big_params, big_stats, NET).items():
        np.testing.assert_allclose(big.state_dict()[name].numpy(), v, rtol=0, atol=1e-5,
                                   err_msg=name)
    # the step from the same weights: a 1e-6 difference in the resized tables
    # moves the stem's gradients (through BN) by more than the step tolerance
    load_jax(big, big_params, big_stats)
    fine = make_train_step(big, make_optimizer(ocfg, big), tcfg,
                           schedule=lr_schedule(ocfg), device="cpu")
    metrics = fine(torch.tensor(images), torch.tensor(labels),
                   draws=StepDraws(drop_keeps=keeps, **draws))
    _check_step(fine, metrics, jmetrics, jgrads, fine_state,
                noisy=[n for n, _ in big.named_parameters() if n.startswith(STEM_CONVS)])

    # eval logits of the finetuned net and of its EMA
    x = np.random.default_rng(3).integers(0, 256, (4, img, img, 3), dtype=np.uint8)
    labels = np.arange(4)
    x_norm = jax_engine._normalize(jnp.asarray(x), JaxTrainConfig())
    for tree, port_params in ((fine_state.params, None),
                              (fine_state.ema_params, fine.state.ema_params)):
        want = np.asarray(jbig.apply({"params": tree, "batch_stats": fine_state.batch_stats},
                                     x_norm))
        big.eval()
        with torch.no_grad():
            inputs = (torch.tensor(np.asarray(x_norm)),)
            got = (big(*inputs) if port_params is None
                   else torch.func.functional_call(big, port_params, inputs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        scored = make_eval_step(big, device="cpu")(torch.tensor(x), torch.tensor(labels),
                                                   params=port_params)
        jscored = jax_engine.make_eval_step(jbig)(tree, fine_state.batch_stats,
                                                  jnp.asarray(x), jnp.asarray(labels))
        np.testing.assert_allclose(float(scored["loss_sum"]), float(jscored["loss_sum"]),
                                   rtol=1e-5)


def test_jax_conv_stem_gradient_is_the_noisy_side():
    """At 112 px the JAX package's float32 gradient of the conv stem (three
    conv + BN + ReLU layers, BN on batch statistics with the fast variance
    E[x^2] - E[x]^2) is off its own float64 value by more than 1e-4 of its
    largest element; the port's float32 gradient stays within 1e-5 of it.
    This is why the finetune's step holds the stem's gradients to 1e-2."""
    from vit_search_tpu.models.patch_embed import PatchConvEmbed as JaxStem
    from vit_search_torch.convert import _to_conv, _to_norm
    from vit_search_torch.models.patch_embed import PatchConvEmbed

    img = FINETUNE[0]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, img, img, 3))
    x[:, :30, :30] *= 2.0
    cot = rng.normal(size=(BATCH, (img // 14) ** 2, 32))

    def jax_grads(dtype):
        stem = JaxStem(img_size=img, patch_size=14, embed_dim=32, mid_chans=24, dtype=dtype)
        v = stem.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3), dtype),
                      deterministic=False)
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), v["params"])

        def f(p):
            out, _ = stem.apply({"params": p, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x, dtype), deterministic=False,
                                mutable=["batch_stats"])
            return jnp.sum(out * jnp.asarray(cot, dtype))

        grads = {}
        for c in ("conv1", "conv2", "conv3"):
            _to_conv(grads, c, jax.tree.map(np.asarray, jax.grad(f)(params)[c]["conv"]))
        return grads, jax.tree.map(lambda a: np.asarray(a, np.float32), params)

    with jax.enable_x64(True):
        want, _ = jax_grads(jnp.float64)
    got32, params = jax_grads(jnp.float32)

    stem = PatchConvEmbed(img, 14, 32, 24, torch.float32, torch.Generator().manual_seed(0))
    sd = {}
    _to_conv(sd, "conv_proj", params["proj"])
    for c in ("conv1", "conv2", "conv3"):
        _to_conv(sd, f"{c}.conv", params[c]["conv"])
        _to_norm(sd, f"{c}.bn", params[c]["bn"])
    stem.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=False)
    (stem(torch.tensor(x, dtype=torch.float32)) * torch.tensor(cot, dtype=torch.float32)
     ).sum().backward()
    worst_jax = 0.0
    for c in ("conv1", "conv2", "conv3"):
        ref = want[f"{c}.weight"]
        scale = np.abs(ref).max()
        port_err = np.abs(getattr(stem, c).conv.weight.grad.numpy() - ref).max() / scale
        assert port_err < 1e-5, (c, port_err)
        worst_jax = max(worst_jax, np.abs(got32[f"{c}.weight"] - ref).max() / scale)
    assert worst_jax > 1e-4
