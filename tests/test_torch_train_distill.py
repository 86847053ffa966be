"""Dropout, and one mixup + knowledge-distillation train step, of the port
against the JAX package.

The small conv-stem net of test_torch_model (56 px, three stages), with a
distill token, on both sides from the same weights:

- a training forward with dropout (and attention dropout) at 0.1, the keep
  masks injected on both sides: the port takes them as ``dropout_keeps`` in
  call order (shapes from ``model.dropout_shapes``), and flax's
  ``nn.Dropout`` is replaced for the test by one that takes the same masks in
  the same order, as test_torch_train_step replaces ``layers._drop_path``;
- one supernet train step with timm Mixup/CutMix (the JAX step's draws,
  rebuilt from its key), dropout 0.1 and stochastic depth (keeps fixed on
  both sides), and hard distillation from a narrow RegNetY teacher that
  resizes the 56 px batch to 32 px (the JAX side: ``jax.image.resize`` then
  the JAX ``RegNetY``, which is what its ``RegNetYUpsample`` runs). Loss,
  gradient norm, gradients and parameters after AdamW are held to
  test_torch_train_step's tolerances.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.data import mixup as jax_mixup
from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.models import layers as jax_layers
from vit_search_tpu.models import regnet as jax_regnet
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
from vit_search_torch.data import mixup_cutmix
from vit_search_torch.models import (RegNetYUpsample, SupernetSchedules,
                                     VisionTransformerSR, build_arch_masks)
from vit_search_torch.train import (OptimConfig, StepDraws, TrainConfig, lr_schedule,
                                    make_optimizer, make_teacher, make_train_step)

from test_torch_mixup_cutmix import jax_mixup_draws
from test_torch_model import NET, SPACE

BATCH, IMG, CLASSES, DPR, DROP = 8, 56, 10, 0.1, 0.1
TEACHER = dict(widths=(16, 32), depths=(1, 2), group_width=8, stem_width=8,
               num_classes=CLASSES)
TEACHER_IMG = 32
MIXUP = dict(mixup_alpha=0.8, cutmix_alpha=1.0, mixup_switch_prob=0.5, mixup_prob=1.0,
             mixup_elem_mode="elem")


@pytest.fixture
def fixed_keeps(monkeypatch):
    """Make the JAX model take fixed stochastic-depth keeps and dropout masks,
    each in call order; returns ``(set_dropout_keeps, drop_path_keeps)``."""
    rng = np.random.default_rng(7)
    path_keeps = [rng.random(BATCH) < 1.0 - DPR for _ in range(6)]
    path_keeps[0][:2] = False
    calls = {"path": 0, "dropout": 0}
    dropout_keeps = []

    def drop_path(x, rate, key, deterministic):
        keep = jnp.asarray(path_keeps[calls["path"] % len(path_keeps)])
        calls["path"] += 1
        return jnp.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)), x / (1.0 - rate),
                         jnp.zeros_like(x))

    def dropout_call(self, inputs, deterministic=None, rng=None):
        deterministic = nn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = dropout_keeps[calls["dropout"] % len(dropout_keeps)]
        calls["dropout"] += 1
        assert keep.shape == inputs.shape, (keep.shape, inputs.shape)
        return jnp.where(jnp.asarray(keep), inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    def set_dropout_keeps(shapes, seed=11):
        r = np.random.default_rng(seed)
        dropout_keeps[:] = [r.random(s) >= DROP for s in shapes]
        calls["dropout"] = 0
        return [torch.tensor(k) for k in dropout_keeps]

    monkeypatch.setattr(jax_layers, "_drop_path", drop_path)
    monkeypatch.setattr(nn.Dropout, "__call__", dropout_call)
    return set_dropout_keeps, path_keeps


def _models(attn_drop=0.0, dpr=DPR):
    jmodel = JaxViT(network_def=NET, img_size=IMG, patch_size=14, num_classes=CLASSES,
                    distill_token=True, drop_path_rate=dpr, dropout_rate=DROP,
                    attn_dropout_rate=attn_drop)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    model = VisionTransformerSR(NET, img_size=IMG, patch_size=14, num_classes=CLASSES,
                                distill_token=True, drop_path_rate=dpr, dropout_rate=DROP,
                                attn_dropout_rate=attn_drop, device="cpu")
    load_jax(model, params, stats)
    return jmodel, params, stats, model


@pytest.mark.parametrize("attn_drop", [0.0, DROP], ids=["dropout", "dropout_and_attn"])
def test_dropout_forward_matches_jax(fixed_keeps, attn_drop):
    set_dropout_keeps, _ = fixed_keeps
    jmodel, params, stats, model = _models(attn_drop, dpr=0.0)
    shapes = model.dropout_shapes(BATCH)
    # pos_drop, then per block: [attention probs], projection, GELU, fc2
    assert len(shapes) == 1 + 4 * (3 + (attn_drop > 0))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    counts = JaxSchedules(NET, SPACE, 2, 0).sample_packed(rng, BATCH)
    jax_masks = jax_build_arch_masks(JaxSchedules(NET, SPACE, 2, 0).unpack(
        jnp.asarray(counts), BATCH), NET, BATCH)
    keeps = set_dropout_keeps(shapes)
    apply = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, deterministic=False,
                                                 rngs={"dropout": jax.random.PRNGKey(0)},
                                                 mutable=["batch_stats"]))
    (cls_ref, dst_ref), _ = apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  jax_masks)
    masks = SupernetSchedules(NET, SPACE, 2, 0).unpack(counts, BATCH)
    model.train()
    cls, dst = model(torch.tensor(x), build_arch_masks(masks, NET, BATCH), dropout_keeps=keeps)
    for got, want in ((cls, cls_ref), (dst, dst_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    # the masks matter: without them (fresh draws) the logits move
    model.train()
    other, _ = model(torch.tensor(x), build_arch_masks(masks, NET, BATCH),
                     generator=torch.Generator().manual_seed(0))
    assert not np.allclose(other.detach().numpy(), np.asarray(cls_ref), atol=1e-3)


def test_dropout_keeps_must_fit_and_eval_draws_none():
    _, _, _, model = _models()
    x = torch.zeros(2, IMG, IMG, 3)
    model.train()
    with pytest.raises(ValueError, match="dropout keep of shape"):
        model(x, dropout_keeps=[torch.ones(3, 3, dtype=torch.bool)])
    model.eval()
    with torch.no_grad():
        model(x, dropout_keeps=[])      # eval mode consumes no keep


def test_mixup_distill_dropout_step_matches_jax(fixed_keeps):
    set_dropout_keeps, path_keeps = fixed_keeps
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, BATCH)
    jmodel, params, stats, model = _models()
    dropout_keeps = set_dropout_keeps(model.dropout_shapes(BATCH))

    # the teacher: a narrow RegNetY behind a 56 -> 32 px resize
    jteacher = jax_regnet.RegNetY(**TEACHER)
    tvars = jax.jit(jteacher.init)(jax.random.PRNGKey(5), jnp.zeros((1, TEACHER_IMG,
                                                                     TEACHER_IMG, 3)))

    def teacher_apply(x):
        x = jax.image.resize(x, (x.shape[0], TEACHER_IMG, TEACHER_IMG, 3), method="bicubic")
        return jteacher.apply(tvars, x, deterministic=True)

    teacher = RegNetYUpsample(target_size=TEACHER_IMG, **TEACHER, device="cpu")
    load_jax(teacher, {"regnet": jax.tree.map(np.asarray, tvars["params"])},
             {"regnet": jax.tree.map(np.asarray, tvars["batch_stats"])})

    # --- JAX: the step, and its gradients from the same loss
    jsched = JaxSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    counts = jsched.sample_packed(np.random.default_rng(1), BATCH)
    jocfg = JaxOptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH)
    tx = jax_make_optimizer(jocfg, params)
    jtcfg = JaxTrainConfig(num_classes=CLASSES, mixup_mode="mixup", **MIXUP,
                           distill_alpha=0.5, hard_distill=True)
    jstep = jax_make_train_step(jmodel, tx, jtcfg, teacher_apply=teacher_apply,
                                schedule=jax_schedule(jocfg), donate=False,
                                counts_unpack=jsched.unpack)
    key = jax.random.PRNGKey(42)
    new_state, jmetrics = jstep(TrainState.create(params, tx, stats), jnp.asarray(images),
                                jnp.asarray(labels), jnp.asarray(counts), key)

    k_mix, k_drop, k_path, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    x = jax_engine._normalize(jnp.asarray(images), jtcfg)
    masks = jax_build_arch_masks(jsched.unpack(jnp.asarray(counts), BATCH), NET, BATCH)
    images_m, targets = jax_mixup.mixup_cutmix(
        k_mix, x, jnp.asarray(labels), CLASSES, 0.8, 1.0, 0.5, 0.1, 1.0, mode="elem")
    teacher_logits = teacher_apply(images_m)

    def loss_fn(p):
        (cls, dst), _ = jmodel.apply({"params": p, "batch_stats": stats}, images_m, masks,
                                     deterministic=False, rngs={"dropout": k_drop,
                                                                "drop_path": k_path},
                                     mutable=["batch_stats"])
        loss = jax_losses.soft_target_cross_entropy(cls, targets)
        kd = jax_losses.distillation_loss(dst, teacher_logits, hard=True)
        return loss * 0.5 + kd * 0.5

    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))

    # --- the port, same weights and draws
    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH)
    sched = SupernetSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    step = make_train_step(model, make_optimizer(ocfg, model),
                           TrainConfig(num_classes=CLASSES, mixup_mode="mixup", **MIXUP,
                                       distill_alpha=0.5, hard_distill=True),
                           schedule=lr_schedule(ocfg), counts_unpack=sched.unpack,
                           device="cpu", teacher=make_teacher(teacher))
    draws = StepDraws(mixup=jax_mixup_draws(k_mix, BATCH, IMG, IMG, 0.8, 1.0, 0.5, 1.0,
                                            "elem", None),
                      drop_keeps=[torch.tensor(k) for k in path_keeps],
                      dropout_keeps=dropout_keeps)
    metrics = step(torch.tensor(images), torch.tensor(labels), counts, draws=draws)
    assert not teacher.training

    # the teacher's logits on the mixed batch, and the hard labels it gives
    with torch.no_grad():
        port_mixed, _ = mixup_cutmix(torch.tensor(np.asarray(x)), torch.tensor(labels),
                                     CLASSES, mode="elem", draws=draws.mixup)
        t_logits = teacher(port_mixed).numpy()
    want_t = np.asarray(teacher_logits)
    np.testing.assert_allclose(t_logits, want_t, rtol=0, atol=1e-4 * np.abs(want_t).max())
    np.testing.assert_array_equal(t_logits.argmax(-1), want_t.argmax(-1))

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    want_grads = from_jax(jgrads, stats, NET)
    for name, p in model.named_parameters():
        g = want_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max() + 1e-9, err_msg=name)
    want = from_jax(jax.tree.map(np.asarray, new_state.params),
                    jax.tree.map(np.asarray, new_state.batch_stats), NET)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    lr = float(jmetrics["lr"])
    for name, v in want.items():
        tol = np.full(v.shape, 1e-6, np.float32)
        if name in want_grads:
            tol[np.abs(want_grads[name]) < 1e-7] = 2 * lr + 1e-6
        err = np.abs(got[name].numpy() - v)
        assert (err <= tol).all(), f"{name}: max err {err.max():.3g}"


def test_mixup_step_with_the_16gf_teacher_runs_on_the_cpu():
    """``make_train_step`` with ``mixup_mode="mixup"`` and
    ``make_teacher(create_model("regnety_160_upsample"))``: a small student
    at 32 px, whose batch the teacher resizes to 224 px, two images."""
    from vit_search_torch.models import create_model

    student = create_model("flexible_vit_patch16_224", img_size=32, num_classes=1000,
                           network_def=((0, 32), (1, (32, 2, 16), (32, 64), 1),
                                        (2, 32, 1000)), device="cpu")
    teacher = make_teacher(create_model("regnety_160_upsample", device="cpu"))
    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=1, global_batch_size=2)
    step = make_train_step(student, make_optimizer(ocfg, student),
                           TrainConfig(mixup_mode="mixup", mixup_elem_mode="pair"),
                           schedule=lr_schedule(ocfg), device="cpu", teacher=teacher)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    metrics = step(images, torch.tensor([1, 7]))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
