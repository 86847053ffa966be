"""The row-statistics op (K5's plain version) and the ``"stats"`` route of
masked layer norm against the JAX package.

The JAX side runs ``row_sum_sumsq`` through its Pallas kernel in interpret
mode. Masked layer norm takes that kernel only under ``VST_PALLAS_LN_STATS=1``,
read into the module global ``_USE_PALLAS_STATS``, and only where ``C % 128 ==
0`` (stats.py:92-93); the tests switch the global on and count the Pallas
calls, so they never compare against the plain XLA route by mistake. The port
runs on CPU tensors, i.e. through K5's plain version inside its autograd
function. Tolerances: float32 sums rtol 1e-5 (the order of the sum differs);
bf16 outputs one bf16 ulp; layer-norm values and gradients as in
test_torch_masked_ln.py; model logits and gradients as in test_torch_model.py
and test_torch_train_step.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.models.supernet import SupernetSchedules as JaxSchedules
from vit_search_tpu.models.supernet import build_arch_masks as jax_build_arch_masks
from vit_search_tpu.ops import masked_layer_norm as jax_masked_ln
from vit_search_tpu.ops.pallas import stats as jax_stats
from vit_search_tpu.train import OptimConfig as JaxOptimConfig
from vit_search_tpu.train import TrainConfig as JaxTrainConfig
from vit_search_tpu.train import TrainState
from vit_search_tpu.train import cosine_schedule as jax_schedule
from vit_search_tpu.train import losses as jax_losses
from vit_search_tpu.train import make_optimizer as jax_make_optimizer
from vit_search_tpu.train import make_train_step as jax_make_train_step
from vit_search_torch.convert import from_jax, load_jax
from vit_search_torch.models import SupernetSchedules, VisionTransformerSR, build_arch_masks
from vit_search_torch.ops.masked_layer_norm import masked_layer_norm
from vit_search_torch.ops.stats import row_sum_sumsq, row_sum_sumsq_plain
from vit_search_torch.train import (OptimConfig, TrainConfig, label_smoothing_cross_entropy,
                                    lr_schedule, make_optimizer, make_train_step)

from test_torch_masked_ln import _assert_match, _data, _jax_fwd_bwd, _torch_fwd_bwd

# the module (``vit_search_tpu.ops.masked_layer_norm`` as an attribute is the
# function of that name)
jax_ln_module = importlib.import_module("vit_search_tpu.ops.masked_layer_norm")
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)}

# conv stem, three stages of widths 128/256/384 (every masked LN has C % 128
# == 0, so the JAX side takes its Pallas statistics kernel) at 56px, patch 14
NET = ((4, 128),
       (1, (128, 2, 32), (128, 256), 1),
       (1, (128, 2, 32), (128, 256), 1),
       (3, 128, 256),
       (1, (256, 4, 32), (256, 512), 1),
       (3, 256, 384),
       (1, (384, 4, 48), (384, 768), 1),
       (2, 384, 10))
SPACE = [np.array([128, 96]),
         {"attn": np.array([64, 32]), "mlp": np.array([256, 192]), "layer": None},
         {"attn": np.array([64, 32]), "mlp": np.array([256, 192]),
          "layer": np.array([128, 0])},
         np.array([256, 192]),
         {"attn": np.array([128, 64]), "mlp": np.array([512, 384]), "layer": None},
         np.array([384, 320]),
         {"attn": np.array([192, 96]), "mlp": np.array([768, 512]), "layer": None},
         None]
BATCH, IMG, CLASSES = 4, 56, 10


@pytest.fixture
def jax_stats_route(monkeypatch):
    """Switch the JAX masked LN onto its Pallas statistics route; returns the
    number of Pallas statistics calls traced so far."""
    calls = [0]
    stats_call = jax_stats._stats_call

    def counted(x):
        calls[0] += 1
        return stats_call(x)

    monkeypatch.setattr(jax_ln_module, "_USE_PALLAS_STATS", True)
    monkeypatch.setattr(jax_stats, "_stats_call", counted)
    return calls


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 17, 128), (3, 5, 256)], ids=["2x17x128", "3x5x256"])
def test_row_sum_sumsq_and_vjp_match_pallas(shape, dtype):
    np_dtype, jdtype, tdtype = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np_dtype)
    g1, g2 = (rng.normal(size=shape[:2]).astype(np.float32) for _ in range(2))

    (s1_ref, s2_ref), vjp = jax.vjp(jax_stats.row_sum_sumsq, jnp.asarray(x, jdtype))
    (gx_ref,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))

    xt = torch.tensor(np.asarray(x, np.float32)).to(tdtype).requires_grad_()
    s1, s2 = row_sum_sumsq(xt)
    plain = row_sum_sumsq_plain(xt.detach())
    gx, = torch.autograd.grad((s1, s2), xt, (torch.tensor(g1), torch.tensor(g2)))

    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == shape[:2]
    assert gx.dtype == tdtype
    for got, want in ((s1, s1_ref), (s2, s2_ref), (plain[0], s1_ref), (plain[1], s2_ref)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    # the gradient is elementwise in float32, then cast: at most one ulp apart
    ulp = 2.0 ** -7 if dtype == "bf16" else 1e-6
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(gx_ref, np.float32),
                               rtol=ulp, atol=ulp)


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("n", [7, 17])
def test_stats_route_masked_ln_matches_jax(jax_stats_route, n, c):
    x, w, bias, mask, g = _data(3, n, c, seed=n + c)
    want = _jax_fwd_bwd(jax_masked_ln, x, w, bias, mask, g)
    assert jax_stats_route[0] > 0, "the JAX side did not take its statistics kernel"

    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, bias))
    y = masked_layer_norm(xt, wt, bt, torch.tensor(mask), route="stats")
    (y * torch.tensor(g)).sum().backward()
    got = (y.detach().numpy(), (xt.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()))
    _assert_match(got, want, "stats route")
    # and the two routes of the port agree
    _assert_match(got, _torch_fwd_bwd(x, w, bias, mask, g), "fused route")


def test_stats_route_dense_path_is_plain():
    x, w, bias, _, g = _data(2, 9, 128, seed=4)
    xt, wt, bt = (torch.tensor(a) for a in (x, w, bias))
    np.testing.assert_array_equal(masked_layer_norm(xt, wt, bt, None, route="stats").numpy(),
                                  masked_layer_norm(xt, wt, bt, None).numpy())
    with pytest.raises(ValueError, match="route"):
        masked_layer_norm(xt, wt, bt, None, route="pallas")


@pytest.fixture(scope="module")
def stats_net():
    jmodel = JaxViT(network_def=NET, img_size=IMG, patch_size=14, num_classes=CLASSES)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, BATCH)
    counts = JaxSchedules(NET, SPACE, example_per_arch=1,
                          num_warmup_epochs=0).sample_packed(rng, BATCH)
    return jmodel, params, stats, images, labels, counts


def _port_model(params, stats):
    model = VisionTransformerSR(NET, img_size=IMG, patch_size=14, num_classes=CLASSES,
                                ln_route="stats", device="cpu")
    load_jax(model, params, stats)
    return model


def test_stats_route_supernet_forward_matches_jax(jax_stats_route, stats_net):
    jmodel, params, stats, images, _, counts = stats_net
    x = np.asarray(images, np.float32) / 255.0
    jax_masks = jax_build_arch_masks(
        JaxSchedules(NET, SPACE, 1, 0).unpack(jnp.asarray(counts), BATCH), NET, BATCH)
    ref = jax.jit(lambda v, im, m: jmodel.apply(v, im, m, deterministic=True))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jax_masks)
    assert jax_stats_route[0] > 0
    model = _port_model(params, stats).eval()
    masks = build_arch_masks(SupernetSchedules(NET, SPACE, 1, 0).unpack(counts, BATCH), NET,
                             BATCH)
    with torch.no_grad():
        got = model(torch.tensor(x), masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_stats_route_train_step_matches_jax(jax_stats_route, stats_net):
    """One label-smoothing step without mixup or stochastic depth (so no draws
    are needed): loss, grad norm, every gradient and the AdamW update."""
    jmodel, params, stats, images, labels, counts = stats_net
    jsched = JaxSchedules(NET, SPACE, example_per_arch=1, num_warmup_epochs=0)
    jocfg = JaxOptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH)
    tx = jax_make_optimizer(jocfg, params)
    jstep = jax_make_train_step(jmodel, tx, JaxTrainConfig(num_classes=CLASSES),
                                schedule=jax_schedule(jocfg), donate=False,
                                counts_unpack=jsched.unpack)
    new_state, jmetrics = jstep(TrainState.create(params, tx, stats), jnp.asarray(images),
                                jnp.asarray(labels), jnp.asarray(counts),
                                jax.random.PRNGKey(0))
    assert jax_stats_route[0] > 0

    masks = jax_build_arch_masks(jsched.unpack(jnp.asarray(counts), BATCH), NET, BATCH)
    x = (jnp.asarray(images, jnp.float32) / 255.0 - jnp.asarray((0.485, 0.456, 0.406))) \
        / jnp.asarray((0.229, 0.224, 0.225))

    def loss_fn(p):
        cls, _ = jmodel.apply({"params": p, "batch_stats": stats}, x, masks,
                              deterministic=False, mutable=["batch_stats"])
        return jax_losses.label_smoothing_cross_entropy(cls, jnp.asarray(labels), 0.1)

    jgrads = from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)), stats, NET)

    model = _port_model(params, stats)
    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH)
    sched = SupernetSchedules(NET, SPACE, example_per_arch=1, num_warmup_epochs=0)
    step = make_train_step(model, make_optimizer(ocfg, model), TrainConfig(num_classes=CLASSES),
                           schedule=lr_schedule(ocfg), counts_unpack=sched.unpack,
                           device="cpu")
    metrics = step(torch.tensor(images), torch.tensor(labels), counts)

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    # gradients before the update are gone: compare the update, and the
    # gradients through a second backward of the same loss on fresh weights
    lr = float(jmetrics["lr"])
    want = from_jax(jax.tree.map(np.asarray, new_state.params),
                    jax.tree.map(np.asarray, new_state.batch_stats), NET)
    got = model.state_dict()
    for name, v in want.items():
        tol = np.full(v.shape, 1e-6, np.float32)
        if name in jgrads:
            tol[np.abs(jgrads[name]) < 1e-7] = 2 * lr + 1e-6
        err = np.abs(got[name].numpy() - v)
        assert (err <= tol).all(), f"{name}: max err {err.max():.3g}"

    fresh = _port_model(params, stats).train()
    masks_t = build_arch_masks(sched.unpack(counts, BATCH), NET, BATCH)
    xt = (torch.tensor(images).float() / 255.0 - torch.tensor((0.485, 0.456, 0.406))) \
        / torch.tensor((0.229, 0.224, 0.225))
    label_smoothing_cross_entropy(fresh(xt, masks_t), torch.tensor(labels), 0.1).backward()
    for name, p in fresh.named_parameters():
        g = jgrads[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max() + 1e-9, err_msg=name)
