"""The separate-q/k/v and sequence-major attention ops against the JAX
package.

The JAX side runs its Pallas kernels in interpret mode: ``fused_attention_packed``
and ``fused_attention`` (kernels K6/K7 in the port), ``fused_attention_qkv_t``
(K8/K9). The port runs on CPU tensors, i.e. through the kernels' plain
versions inside its autograd functions. Inputs are numpy arrays from a seed.

Tolerances: float32 outputs rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 1e-4 (the order of the sums differs); bfloat16 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.ops.pallas import attention as jax_attention
from vit_search_torch.ops import attention as A

DTYPES = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": ((1e-4, 1e-5), (1e-3, 1e-4)), "bf16": ((5e-2, 5e-2), (5e-2, 5e-2))}
# (N, heads, head_dim): odd lengths and one even, several head counts and sizes
SHAPES = [(9, 2, 16), (16, 4, 8), (17, 3, 8), (33, 2, 32)]
SHAPE_IDS = [f"n{n}h{h}d{d}" for n, h, d in SHAPES]
BATCH = 2


def _arrays(rng, shapes, dtype):
    """Seeded normal arrays: the JAX inputs in ``dtype``, and the same values
    as torch tensors."""
    np_dtype, torch_dtype = DTYPES[dtype]
    out = []
    for shape in shapes:
        x = rng.normal(size=shape).astype(np.float32)
        out.append((jnp.asarray(x, np_dtype), torch.tensor(x).to(torch_dtype)))
    return out


def _close(got, want, tol, name):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=name)


def _port_vjp(fn, inputs, g):
    """The port's output and the gradient of every input, through autograd."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,heads,d", SHAPES, ids=SHAPE_IDS)
def test_fused_attention_packed_matches_jax(n, heads, d, dtype):
    rng = np.random.default_rng(n * heads * d)
    scale = d ** -0.5
    (q, tq), (k, tk), (v, tv), (g, tg) = _arrays(rng, [(BATCH, n, heads * d)] * 4, dtype)
    out_ref, vjp = jax.vjp(
        lambda *a: jax_attention.fused_attention_packed(*a, scale, heads), q, k, v)
    grads_ref = vjp(g)
    fwd_tol, grad_tol = TOL[dtype]

    out, grads = _port_vjp(lambda *a: A.fused_attention_packed(*a, scale, heads),
                           (tq, tk, tv), tg)
    assert out.dtype == tq.dtype
    _close(out, out_ref, fwd_tol, "out")
    _close(A.attention_plain(tq, tk, tv, scale, heads), out_ref, fwd_tol, "plain out")
    plain_grads = A.attention_bwd_plain(tq, tk, tv, tg, scale, heads)
    for name, got, plain, want in zip(("dq", "dk", "dv"), grads, plain_grads, grads_ref):
        _close(got, want, grad_tol, name)
        _close(plain, want, grad_tol, f"plain {name}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,heads,d", SHAPES, ids=SHAPE_IDS)
def test_fused_attention_matches_jax(n, heads, d, dtype):
    """``(B, N, H, D)`` inputs, reshaped to the separate-q/k/v form."""
    rng = np.random.default_rng(n + heads + d)
    scale = d ** -0.5
    (q, tq), (k, tk), (v, tv), (g, tg) = _arrays(rng, [(BATCH, n, heads, d)] * 4, dtype)
    out_ref, vjp = jax.vjp(lambda *a: jax_attention.fused_attention(*a, scale), q, k, v)
    grads_ref = vjp(g)
    fwd_tol, grad_tol = TOL[dtype]

    out, grads = _port_vjp(lambda *a: A.fused_attention(*a, scale), (tq, tk, tv), tg)
    assert out.shape == (BATCH, n, heads, d)
    _close(out, out_ref, fwd_tol, "out")
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        _close(got, want, grad_tol, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,heads,d", SHAPES, ids=SHAPE_IDS)
def test_fused_attention_qkv_t_matches_jax(n, heads, d, dtype):
    rng = np.random.default_rng(7 * n + heads + d)
    scale = d ** -0.5
    w = heads * d
    (qkv_t, tqkv_t), (g, tg) = _arrays(rng, [(n, BATCH, 3 * w), (n, BATCH, w)], dtype)
    out_ref, vjp = jax.vjp(lambda x: jax_attention.fused_attention_qkv_t(x, scale, heads),
                           qkv_t)
    (grad_ref,) = vjp(g)
    fwd_tol, grad_tol = TOL[dtype]

    out, (grad,) = _port_vjp(lambda x: A.fused_attention_qkv_t(x, scale, heads), (tqkv_t,), tg)
    assert out.shape == (n, BATCH, w) and out.dtype == tqkv_t.dtype
    _close(out, out_ref, fwd_tol, "out")
    _close(grad, grad_ref, grad_tol, "dqkv_t")
    _close(A.attention_qkv_t_plain(tqkv_t, scale, heads), out_ref, fwd_tol, "plain out")
    _close(A.attention_qkv_t_bwd_plain(tqkv_t, tg, scale, heads), grad_ref, grad_tol,
           "plain dqkv_t")


def test_layouts_compute_one_function():
    """The sequence-major and separate plain versions are K1/K2's function
    with the axes or the columns moved."""
    rng = np.random.default_rng(3)
    b, n, h, d = 3, 17, 2, 8
    qkv = torch.tensor(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(b, n, h * d)).astype(np.float32))
    want, want_grad = A.attention_qkv_plain(qkv, 0.3, h), A.attention_qkv_bwd_plain(qkv, g, 0.3, h)
    q, k, v = qkv.split(h * d, dim=2)
    qkv_t, g_t = qkv.transpose(0, 1).contiguous(), g.transpose(0, 1).contiguous()
    for got in (A.attention_plain(q, k, v, 0.3, h),
                A.attention_qkv_t_plain(qkv_t, 0.3, h).transpose(0, 1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    for got in (torch.cat(A.attention_bwd_plain(q, k, v, g, 0.3, h), dim=2),
                A.attention_qkv_t_bwd_plain(qkv_t, g_t, 0.3, h).transpose(0, 1)):
        np.testing.assert_allclose(got.numpy(), want_grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wrapper,args", [
    ("attention_fwd_cuda", lambda x: (x, x, x)),
    ("attention_bwd_cuda", lambda x: (x, x, x, x)),
    ("attention_qkv_t_fwd_cuda", lambda x: (torch.cat([x] * 3, dim=2),)),
    ("attention_qkv_t_bwd_cuda", lambda x: (torch.cat([x] * 3, dim=2), x)),
], ids=["K6", "K7", "K8", "K9"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, args):
    """A wrapper launches its kernel or raises; it never falls back to the
    plain version (the autograd functions choose that by device)."""
    x = torch.zeros(1, 9, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(A, wrapper)(*args(x), 0.25, 2)
