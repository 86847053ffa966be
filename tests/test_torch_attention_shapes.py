"""Attention at shapes past the 224 px supernet's: the port against the JAX
package.

- The 392 px finetune's stage shapes (N = 785 / 197 / 50 at head dims 32 /
  48 / 64, ``flexible_vit_sr_patch14_392_patch_output``): the port's fused
  op on CPU tensors (its kernels' plain versions) against the JAX op, whose
  Pallas kernels run in interpret mode on the CPU.
- Head dims: the port's dispatch rule takes every multiple of 8 up to 128
  (what the card's kernels take) and sends the rest to the plain version;
  a small net with head dim 24 against the JAX model, forward, loss and
  gradients.

Inputs are numpy arrays from a seed. Tolerances as in test_torch_attention:
float32 outputs rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.ops.pallas.attention import fused_attention_qkv as jax_attention_qkv
from vit_search_tpu.ops.pallas.attention import supported as jax_supported
from vit_search_torch.convert import from_jax, load_jax
from vit_search_torch.models import VisionTransformerSR
from vit_search_torch.models import layers
from vit_search_torch.ops import attention as A

# (N, heads, head_dim) of the 392 px finetune's three stages, at a few heads
FINETUNE_392 = [(785, 2, 32), (197, 3, 48), (50, 3, 64)]


@pytest.mark.parametrize("n,heads,d", FINETUNE_392,
                         ids=[f"n{n}h{h}d{d}" for n, h, d in FINETUNE_392])
def test_attention_at_392px_shapes_matches_jax(n, heads, d):
    rng = np.random.default_rng(n + d)
    w = heads * d
    qkv = rng.normal(size=(1, n, 3 * w)).astype(np.float32)
    g = rng.normal(size=(1, n, w)).astype(np.float32)
    scale = d ** -0.5
    out_ref, vjp = jax.vjp(lambda x: jax_attention_qkv(x, scale, heads), jnp.asarray(qkv))
    (dqkv_ref,) = vjp(jnp.asarray(g))

    x = torch.tensor(qkv, requires_grad=True)
    out = A.fused_attention_qkv(x, scale, heads)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dqkv_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(A.attention_qkv_bwd_plain(torch.tensor(qkv), torch.tensor(g),
                                                         scale, heads).numpy(),
                               np.asarray(dqkv_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128])
def test_supported_takes_every_multiple_of_8_up_to_128(d):
    """Where the kernels take the head dim the port's rule agrees with JAX's."""
    assert A.supported(65, d, 0.0) and jax_supported(65, d, 0.0)


@pytest.mark.parametrize("d", [12, 20, 33, 136, 256])
def test_supported_refuses_head_dims_the_kernels_do_not_take(d):
    """JAX's rule takes any d >= 8; the port sends these to the plain version."""
    assert jax_supported(65, d, 0.0) and not A.supported(65, d, 0.0)


@pytest.mark.parametrize("head_dim,fused", [(24, True), (12, False)], ids=["d24", "d12"])
def test_attention_layer_dispatches_by_head_dim(monkeypatch, head_dim, fused):
    """Head dim 24 goes to the fused op (K1/K2 on the card), 12 to the plain
    version; both compute one function."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        monkeypatch.setattr(layers, name, wrapped)

    spy("fused_attention_qkv", A.fused_attention_qkv)
    spy("attention_qkv_plain", A.attention_qkv_plain)
    gen = torch.Generator().manual_seed(0)
    layer = layers.Attention(48, 48 // head_dim, head_dim, 48, torch.float32, gen)
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 17, 48)).astype(np.float32))
    out = layer(x)
    assert calls == ["fused_attention_qkv" if fused else "attention_qkv_plain"]
    qkv = layers.linear(x, layer.qkv, torch.float32)
    want = A.attention_qkv_plain(qkv, head_dim ** -0.5, 48 // head_dim)
    np.testing.assert_allclose(out.detach().numpy(),
                               layers.linear(want, layer.proj, torch.float32).detach().numpy(),
                               rtol=1e-6, atol=1e-6)


# conv stem, two stages at 56px, patch 14: N = 17 at head dim 24, then N = 5
NET_D24 = ((4, 48),
           (1, (48, 2, 24), (48, 96), 1),
           (1, (48, 2, 24), (48, 96), 1),
           (3, 48, 96),
           (1, (96, 4, 24), (96, 192), 1),
           (2, 96, 10))


def test_net_at_head_dim_24_matches_jax():
    """Forward, loss and gradients of a net whose attention has head dim 24:
    JAX runs its Pallas kernel (interpret mode), the port its fused op's
    plain versions."""
    img, classes, batch = 56, 10, 4
    jmodel = JaxViT(network_def=NET_D24, img_size=img, patch_size=14, num_classes=classes)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, img, img, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    labels = rng.integers(0, classes, batch)

    def jax_loss(p):
        logits = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), None,
                              deterministic=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1)), logits

    (loss_ref, logits_ref), grads_ref = jax.value_and_grad(jax_loss, has_aux=True)(params)

    model = VisionTransformerSR(NET_D24, img_size=img, patch_size=14, num_classes=classes,
                                device="cpu")
    load_jax(model, params, stats)
    model.eval()
    logits = model(torch.tensor(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    want = from_jax(jax.tree.map(np.asarray, grads_ref), stats, NET_D24)
    for name, p in model.named_parameters():
        g = want[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max() + 1e-9, err_msg=name)
