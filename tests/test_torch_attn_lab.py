"""The port's attention lab against the JAX lab.

The JAX side runs the lab's own calls (``call_fwd``, ``call_bwd``,
``call_split`` of vit_search_tpu/tools/attn_lab.py) with ``pl.pallas_call``
patched to interpret mode, since they pass no ``interpret=`` flag and the
CPU backend takes only interpret mode. The port runs on CPU tensors, i.e.
through the plain versions of K10 (``_fwd_kernel_T``), K11
(``_bwd_kernel_T``) and K12a + K12b (``_dq_kernel`` + ``_dkv_kernel``).
Inputs are numpy arrays from a seed, group size g = 1.

Tolerances, as in test_torch_attention_layouts.py: float32 outputs rtol 1e-4
/ atol 1e-5, gradients rtol 1e-3 / atol 1e-4 (the order of the sums
differs); bfloat16 5e-2.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vit_search_tpu.ops.pallas import attention as jax_attention
from vit_search_tpu.tools import attn_lab as jax_lab
from vit_search_torch.ops import attention as A
from vit_search_torch.tools import attn_lab as lab

DTYPES = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": ((1e-4, 1e-5), (1e-3, 1e-4)), "bf16": ((5e-2, 5e-2), (5e-2, 5e-2))}
# (N, heads, head_dim): odd lengths, even ones, several head counts and sizes
SHAPES = [(9, 2, 16), (17, 3, 8), (18, 2, 32), (33, 2, 32)]
SHAPE_IDS = [f"n{n}h{h}d{d}" for n, h, d in SHAPES]
BATCH = 2
TINY = [("tiny", 2, 9, 2, 8)]


@pytest.fixture
def interpret(monkeypatch):
    """The JAX lab's ``pl.pallas_call`` in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(n, heads, d, dtype, seed):
    """Seeded ``(B, N, 3W)`` qkv and ``(B, N, W)`` do: the JAX arrays in
    ``dtype``, and the same values as torch tensors."""
    np_dtype, torch_dtype = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for width in (3 * heads * d, heads * d):
        x = rng.normal(size=(BATCH, n, width)).astype(np.float32)
        out.append((jnp.asarray(x, np_dtype), torch.tensor(x).to(torch_dtype)))
    return out


def _close(got, want, tol, name):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,heads,d", SHAPES, ids=SHAPE_IDS)
def test_fwd_T_matches_jax_lab(interpret, n, heads, d, dtype):
    (qkv, tqkv), _ = _inputs(n, heads, d, dtype, seed=n * heads * d)
    scale = d ** -0.5
    want = jax_lab.call_fwd(jax_lab._fwd_kernel_T, qkv, scale, heads, 1)
    got = lab.call_fwd(tqkv, scale, heads, "T")
    assert got.dtype == tqkv.dtype and got.shape == (BATCH, n, heads * d)
    _close(got, want, TOL[dtype][0], "K10")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,heads,d", SHAPES, ids=SHAPE_IDS)
def test_bwd_T_matches_jax_lab(interpret, n, heads, d, dtype):
    (qkv, tqkv), (do, tdo) = _inputs(n, heads, d, dtype, seed=n + heads + d)
    scale = d ** -0.5
    want = jax_lab.call_bwd(jax_lab._bwd_kernel_T, qkv, do, scale, heads, 1)
    got = lab.call_bwd(tqkv, tdo, scale, heads, "T")
    assert got.dtype == tqkv.dtype and got.shape == tqkv.shape
    _close(got, want, TOL[dtype][1], "K11")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,heads,d", SHAPES, ids=SHAPE_IDS)
def test_split_matches_jax_lab(interpret, n, heads, d, dtype):
    """The concatenated K12a + K12b against the lab's ``call_split``, and each
    half against its own Pallas kernel's columns."""
    (qkv, tqkv), (do, tdo) = _inputs(n, heads, d, dtype, seed=7 * n + heads + d)
    scale = d ** -0.5
    want = np.asarray(jax_lab.call_split(qkv, do, scale, heads, 1), np.float32)
    got = lab.call_split(tqkv, tdo, scale, heads)
    assert got.dtype == tqkv.dtype and got.shape == tqkv.shape
    w = heads * d
    tol = TOL[dtype][1]
    _close(got, want, tol, "K12")
    _close(lab.split_dq_plain(tqkv, tdo, scale, heads), want[..., :w], tol, "K12a")
    _close(lab.split_dkv_plain(tqkv, tdo, scale, heads), want[..., w:], tol, "K12b")


def test_backwards_compute_one_function():
    """K11's and the split's plain versions are K2's function."""
    (_, qkv), (_, do) = _inputs(17, 3, 8, "f32", seed=3)
    want = A.attention_qkv_bwd_plain(qkv, do, 0.3, 3)
    for got in (lab.bwd_T_plain(qkv, do, 0.3, 3), lab.split_plain(qkv, do, 0.3, 3)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_fwd_T_keeps_p_in_float32(interpret):
    """K10 does not round p to v's dtype: in bf16 its output differs from
    K1's, as the JAX lab's ``_fwd_kernel_T`` differs from ``_fwd_kernel_qkv``;
    in f32 the two are one function."""
    (qkv, tqkv), _ = _inputs(17, 2, 16, "bf16", seed=0)
    scale = 0.25
    k10, k1 = lab.fwd_T_plain(tqkv, scale, 2), A.attention_qkv_plain(tqkv, scale, 2)
    assert not torch.equal(k10, k1)
    jax_k10 = np.asarray(jax_lab.call_fwd(jax_lab._fwd_kernel_T, qkv, scale, 2, 1), np.float32)
    jax_k1 = np.asarray(jax_lab.call_fwd(jax_attention._fwd_kernel_qkv, qkv, scale, 2, 1),
                        np.float32)
    assert not np.array_equal(jax_k10, jax_k1)
    # each port version is nearer its own Pallas kernel than the other's
    assert np.abs(k10.float().numpy() - jax_k10).max() < np.abs(k1.float().numpy() - jax_k10).max()
    assert np.abs(k1.float().numpy() - jax_k1).max() < np.abs(k10.float().numpy() - jax_k1).max()
    x = tqkv.float()
    assert torch.equal(lab.fwd_T_plain(x, scale, 2), A.attention_qkv_plain(x, scale, 2))


@pytest.mark.parametrize("wrapper,with_do", [
    ("fwd_T_cuda", False), ("bwd_T_cuda", True), ("split_dq_cuda", True),
    ("split_dkv_cuda", True)], ids=["K10", "K11", "K12a", "K12b"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, with_do):
    """A wrapper launches its kernel or raises; it never falls back to the
    plain version (the lab's calls choose that by device)."""
    x = torch.zeros(1, 9, 16)
    args = (torch.cat([x] * 3, dim=2), x) if with_do else (torch.cat([x] * 3, dim=2),)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(lab, wrapper)(*args, 0.25, 2)


def test_main_runs_on_the_cpu(capsys):
    records = lab.main(TINY, iters=1, device="cpu")
    out = capsys.readouterr().out
    assert "on the CPU" in out and "bwd_err=" in out and "fwd_err=" in out
    assert all(f"{d} {v}" in out for d in ("bwd", "fwd") for v in ("base", "T"))
    (r,) = records
    assert r["bwd_err"] <= 5e-2 * r["bwd_ref_max"] and 0 < r["fwd_err"] <= 5e-2 * r["fwd_ref_max"]
    assert set(r["ms"]) == {"bwd base", "bwd T", "fwd base", "fwd T"}


def test_main_split_runs_on_the_cpu(capsys):
    (r,) = lab.main_split(TINY, iters=1, device="cpu")
    out = capsys.readouterr().out
    assert "err=" in out and "base" in out and "split" in out
    assert r["err"] <= 5e-2 * r["ref_max"] and set(r["ms"]) == {"base", "split"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["main", "main_split"])
def test_lab_needs_cuda_unless_cpu_is_asked(no_cuda, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(lab, entry)(TINY, iters=1)
