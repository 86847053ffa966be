"""Fused qkv attention: the port's plain path against the JAX package.

``vit_search_tpu.ops.pallas.attention.fused_attention_qkv`` runs its Pallas
kernels in interpret mode on the CPU; the port's ``fused_attention_qkv`` on
CPU tensors runs the plain versions of its kernels K1/K2 inside its autograd
function. Inputs are float32 numpy arrays from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.ops.pallas.attention import fused_attention_qkv as jax_attention_qkv
from vit_search_tpu.ops.pallas.attention import supported as jax_supported
from vit_search_torch.ops.attention import (attention_qkv_bwd_plain,
                                            attention_qkv_plain,
                                            fused_attention_qkv, supported)


@pytest.mark.parametrize("n,heads,d", [(17, 3, 8), (17, 5, 16), (65, 3, 48), (65, 5, 16)])
def test_attention_matches_jax(n, heads, d):
    rng = np.random.default_rng(n * heads * d)
    b, w = 2, heads * d
    qkv = rng.normal(size=(b, n, 3 * w)).astype(np.float32)
    g = rng.normal(size=(b, n, w)).astype(np.float32)
    scale = d ** -0.5

    out_ref, vjp = jax.vjp(lambda x: jax_attention_qkv(x, scale, heads), jnp.asarray(qkv))
    (dqkv_ref,) = vjp(jnp.asarray(g))

    x = torch.tensor(qkv, requires_grad=True)
    out = fused_attention_qkv(x, scale, heads)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dqkv_ref), rtol=1e-4, atol=1e-5)


def test_plain_backward_is_the_gradient_of_plain_forward():
    """In float32 (where p is not rounded) K2's function is K1's VJP."""
    rng = np.random.default_rng(0)
    qkv = torch.tensor(rng.normal(size=(2, 9, 3 * 24)).astype(np.float32), requires_grad=True)
    g = torch.tensor(rng.normal(size=(2, 9, 24)).astype(np.float32))
    (want,) = torch.autograd.grad(attention_qkv_plain(qkv, 0.3, 3), qkv, g)
    got = attention_qkv_bwd_plain(qkv.detach(), g, 0.3, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_bf16_rounds_probabilities_like_jax():
    """p is cast to v's dtype before p @ v (attention.py:102-104)."""
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(2, 17, 3 * 32)).astype(np.float32)
    ref = jax_attention_qkv(jnp.asarray(qkv, jnp.bfloat16), 0.25, 2)
    got = attention_qkv_plain(torch.tensor(qkv).bfloat16(), 0.25, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n,d,rate", [(8, 8, 0.0), (7, 8, 0.0), (8, 7, 0.0), (257, 32, 0.1)])
def test_dispatch_rule_matches_jax(n, d, rate):
    assert supported(n, d, rate) == jax_supported(n, d, rate)
