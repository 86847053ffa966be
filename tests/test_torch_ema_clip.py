"""The port's EMA update and gradient clipping against the JAX package's.

``ema_update`` is held to vit_search_tpu.train.state.ema_update (same order
of operations, float32) and ``clip_by_global_norm_`` to
``optax.clip_by_global_norm`` with the norm just under, just over and far
over ``max_norm``: the EMA to 1e-7 relative, the clipped gradients to 1e-6
(the two global norms sum their squares in other orders).
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and is another
function; a test shows the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_search_tpu.train.state import ema_update as jax_ema_update
from vit_search_torch.models import VisionTransformerSR
from vit_search_torch.train import (OptimConfig, TrainConfig, clip_by_global_norm_,
                                    ema_update, init_ema, make_optimizer, make_train_step)

SHAPES = {"a.weight": (16, 8), "a.bias": (16,), "b.weight": (3, 5, 2, 2), "tokens": (1, 2, 8)}
TINY_NET = ((0, 16), (1, (16, 2, 8), (16, 32), 1), (2, 16, 4))


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("decay", [0.99996, 0.999, 0.5])
def test_ema_update_matches_jax(decay):
    ema, params = _tree(0), _tree(1)
    want = jax.tree.map(np.asarray, jax_ema_update(ema, params, decay))
    got = {k: torch.tensor(v) for k, v in ema.items()}
    ema_update(got, {k: torch.tensor(v) for k, v in params.items()}, decay)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-7, atol=0, err_msg=k)


def test_init_ema_copies_to_float32_without_aliasing():
    params = {"w": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    ema = init_ema(params)
    assert all(t.dtype == torch.float32 for t in ema.values())
    assert ema["b"].data_ptr() != params["b"].data_ptr()
    ema["b"] += 1
    assert float(params["b"].sum()) == 0.0


def _global_norm(grads):
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


@pytest.mark.parametrize("ratio", [1 + 1e-5, 1 - 1e-5, 0.1], ids=["just_under", "just_over",
                                                                   "far_over"])
def test_clip_by_global_norm_matches_optax(ratio):
    """``max_norm = ratio * norm``: under it nothing moves, over it every
    gradient becomes ``(g / norm) * max_norm``."""
    tree = _tree(2, scale=0.3)
    grads = [torch.tensor(v) for v in tree.values()]
    norm = _global_norm(grads)
    max_norm = float(norm) * ratio
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
    clip_by_global_norm_(grads, max_norm, norm)
    for g, k in zip(grads, tree):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)
    if ratio > 1:
        for g, v in zip(grads, tree.values()):
            assert np.array_equal(g.numpy(), v)
    else:
        np.testing.assert_allclose(float(_global_norm(grads)), max_norm, rtol=1e-6)


def test_clip_at_exactly_max_norm_scales():
    grads = [torch.tensor([3.0, 4.0])]
    clip_by_global_norm_(grads, 5.0, _global_norm(grads))
    assert grads[0].tolist() == [3.0 / 5.0 * 5.0, 4.0 / 5.0 * 5.0]


def test_torch_clip_grad_norm_is_another_function():
    """At a small norm torch's epsilon moves the result by 1e-3 relative;
    the port follows optax."""
    tree = _tree(3, scale=1e-4)
    norm = float(_global_norm([torch.tensor(v) for v in tree.values()]))
    max_norm = norm / 2
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    for p, v in zip(params, tree.values()):
        p.grad = torch.tensor(v)
    torch.nn.utils.clip_grad_norm_(params, max_norm)
    theirs = params[0].grad.numpy()
    ours = [torch.tensor(v) for v in tree.values()]
    clip_by_global_norm_(ours, max_norm, _global_norm(ours))
    ref = np.asarray(want["a.weight"])
    assert np.abs(theirs - ref).max() > 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(ours[0].numpy(), ref, rtol=1e-6, atol=0)


def test_train_step_keeps_an_ema_and_clips():
    model = VisionTransformerSR(TINY_NET, img_size=28, patch_size=7, num_classes=4,
                                device="cpu")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = make_optimizer(OptimConfig(base_lr=1e-2, warmup_epochs=0, clip_grad=1e-3), model)
    step = make_train_step(model, opt, TrainConfig(num_classes=4, ema_decay=0.9,
                                                   erasing_prob=1.0), device="cpu")
    images = torch.randint(0, 256, (4, 28, 28, 3), dtype=torch.uint8)
    metrics = step(images, torch.arange(4))
    assert float(metrics["grad_norm"]) > 1e-3        # measured before clipping
    assert float(_global_norm([p.grad for p in step.params])) == pytest.approx(1e-3, rel=1e-5)
    for k, p in model.named_parameters():
        want = before[k] * 0.9 + p.detach() * (1 - 0.9)
        np.testing.assert_allclose(step.state.ema_params[k].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert not torch.equal(step.state.ema_params["cls_head.weight"], model.cls_head.weight)
