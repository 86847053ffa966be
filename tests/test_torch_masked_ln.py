"""Masked layer norm: the port's plain path against the JAX package.

The same numpy inputs go through ``vit_search_tpu.ops.masked_layer_norm``
(plain JAX), ``masked_layer_norm_pallas`` (the Pallas kernel, interpret mode
on the CPU) and the port's ``masked_layer_norm`` on CPU tensors, which runs
the plain versions of the port's kernels K3/K4 inside its autograd function.
Tolerances as in test_pallas.py: rtol/atol 1e-5 forward, 1e-4/1e-5 gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.ops import masked_layer_norm as jax_masked_ln
from vit_search_tpu.ops.pallas import masked_layer_norm_pallas
from vit_search_torch.ops.masked_layer_norm import (masked_layer_norm,
                                                    masked_ln_bwd_plain,
                                                    masked_ln_fwd_plain)


def _data(b, n, c, seed, shared_mask=False):
    rng = np.random.default_rng(seed)
    keep = rng.integers(c // 4, c + 1, size=1 if shared_mask else b)
    mask = (np.arange(c)[None, None, :] < keep[:, None, None]).astype(np.float32)
    x = rng.normal(size=(b, n, c)).astype(np.float32) * mask
    w = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    g = rng.normal(size=(b, n, c)).astype(np.float32)
    return x, w, bias, mask, g


def _torch_fwd_bwd(x, w, bias, mask, g):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    y = masked_layer_norm(xt, wt, bt, None if mask is None else torch.tensor(mask))
    (y * torch.tensor(g)).sum().backward()
    return y.detach().numpy(), (xt.grad.numpy(), wt.grad.numpy(), bt.grad.numpy())


def _jax_fwd_bwd(fn, x, w, bias, mask, g):
    m = None if mask is None else jnp.asarray(mask)

    def loss(x_, w_, b_):
        return jnp.sum(fn(x_, w_, b_, m) * g)

    y = fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), m)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(bias))
    return np.asarray(y), tuple(np.asarray(a) for a in grads)


def _assert_match(got, want, what):
    (y, grads), (y_ref, grads_ref) = got, want
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5, err_msg=f"{what} y")
    for a, e, name in zip(grads, grads_ref, ("gx", "gw", "gb")):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-5, err_msg=f"{what} {name}")


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("n", [7, 17, 65])
def test_masked_ln_matches_jax_and_pallas(n, c):
    x, w, bias, mask, g = _data(3, n, c, seed=n * c)
    got = _torch_fwd_bwd(x, w, bias, mask, g)
    _assert_match(got, _jax_fwd_bwd(jax_masked_ln, x, w, bias, mask, g), "plain JAX")
    _assert_match(got, _jax_fwd_bwd(masked_layer_norm_pallas, x, w, bias, mask, g),
                  "Pallas")


def test_masked_ln_batch1_mask_broadcast():
    """A (1, 1, C) mask serves every example, as masked_layer_norm.py:71-73."""
    x, w, bias, mask, g = _data(4, 17, 128, seed=5, shared_mask=True)
    assert mask.shape[0] == 1
    _assert_match(_torch_fwd_bwd(x, w, bias, mask, g),
                  _jax_fwd_bwd(jax_masked_ln, x, w, bias, mask, g), "broadcast mask")


def test_dense_layer_norm_matches_jax():
    x, w, bias, _, g = _data(2, 9, 64, seed=9)
    _assert_match(_torch_fwd_bwd(x, w, bias, None, g),
                  _jax_fwd_bwd(jax_masked_ln, x, w, bias, None, g), "dense")


def test_plain_backward_is_the_gradient_of_plain_forward():
    """K4's plain function equals autograd through K3's plain function."""
    x, w, bias, mask, g = _data(2, 17, 128, seed=11)
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, bias))
    mt, gt = torch.tensor(mask), torch.tensor(g)
    y, stats = masked_ln_fwd_plain(xt, mt, wt, bt, 1e-6)
    want = torch.autograd.grad((y * gt).sum(), (xt, wt, bt))
    got = masked_ln_bwd_plain(xt.detach(), mt, wt.detach(), stats.detach(), gt)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-4, atol=1e-5)


def test_bf16_output_dtype_and_stats_in_f32():
    x, w, bias, mask, _ = _data(2, 7, 128, seed=3)
    y, stats = masked_ln_fwd_plain(torch.tensor(x).bfloat16(), torch.tensor(mask).bfloat16(),
                                   torch.tensor(w), torch.tensor(bias), 1e-6)
    assert y.dtype == torch.bfloat16 and stats.dtype == torch.float32
    assert stats.shape == (2, 7, 2)
    ref = np.asarray(jax_masked_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                   jnp.asarray(mask)))
    np.testing.assert_allclose(y.float().numpy(), ref, atol=0.1)
