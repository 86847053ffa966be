"""The rounding contract of the bfloat16 attention kernels, on the CPU.

On the card a bfloat16 call of K1/K2 (and K6-K9) runs the tensor-core body of
``csrc/attention.cu``. Its forward rounds p where the TPU kernel does:
normalised, then to bfloat16, before ``p @ v``. Its backward takes p and ds
as bfloat16 operands of ``dv = p^T do``, ``dq = ds k`` and ``dk = ds^T q``,
where the TPU kernel keeps them in float32; ``delta = rowsum(dp * p)`` comes
from the float32 p and dp, and ``ds = p * (dp - delta)`` is formed in float32
before it is rounded. The kernel cannot run here, so this file emulates that
rounding in plain PyTorch and holds the emulation to the plain versions (the
float32 function) within ``chip_smoke.BF16_TOL``, the rule the card holds the
kernels to, and to the JAX kernel in bfloat16 (interpret mode on the CPU).

The lab's split backward (K12a: dq; K12b: dk and dv) runs the tensor-core
split bodies in bfloat16, which round as K2's body: each recomputes p, dp,
delta and ds in float32 and takes p and ds as bfloat16 operands only. Its
emulation is held to the split's plain versions and to the JAX lab's
``call_split`` in bfloat16 (``pl.pallas_call`` patched to interpret mode, as
in test_torch_attn_lab.py).

The lab's K10 (forward) and K11 (one-launch backward) keep the JAX lab's
float32 function: in bfloat16 they run the same tensor-core bodies, but p
and ds go into the products as bfloat16 hi/lo pairs (x_hi = bf16(x), x_lo =
bf16(x - x_hi)), both products summed in float32, so p and ds keep about 16
bits where one bfloat16 operand keeps 8. Their emulation is held to the
lab's plain versions and to the JAX lab's ``_fwd_kernel_T`` and
``_bwd_kernel_T`` in bfloat16, and shown to come closer to the float32
function than K1's and K2's rounding. Inputs are numpy arrays from a seed,
rounded to bfloat16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from chip_smoke import BF16_TOL
from vit_search_tpu.ops.pallas.attention import fused_attention_qkv as jax_attention_qkv
from vit_search_tpu.tools import attn_lab as jax_lab
from vit_search_torch.ops import attention as A
from vit_search_torch.tools import attn_lab as lab

# (N, heads, head_dim): the three stage shapes, then a ragged N with D = 8
SHAPES = [(257, 6, 32), (65, 12, 48), (17, 12, 64), (33, 3, 8)]
SHAPE_IDS = [f"n{n}h{h}d{d}" for n, h, d in SHAPES]
JAX_SHAPES = [(65, 2, 48), (17, 3, 64)]
BATCH = 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _inputs(n: int, h: int, d: int, seed: int):
    """Seeded bfloat16 ``(B, N, 3W)`` projection and ``(B, N, W)`` cotangent
    as numpy float32 arrays holding bfloat16 values."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(BATCH, n, 3 * h * d)).astype(np.float32)
    do = rng.normal(size=(BATCH, n, h * d)).astype(np.float32)
    return (_bf16(torch.tensor(qkv)).numpy(), _bf16(torch.tensor(do)).numpy())


def emulate_fwd(qkv: torch.Tensor, scale: float, h: int) -> torch.Tensor:
    """The tensor-core forward's rounding: s and softmax in f32, p
    normalised then rounded to bf16, ``p @ v`` summed in f32, out in bf16."""
    q, k, v = A._split(qkv, h)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    o = torch.einsum("bhnm,bmhd->bnhd", _bf16(p), v)
    return o.reshape(qkv.shape[0], qkv.shape[1], -1).to(torch.bfloat16)


def emulate_bwd(qkv: torch.Tensor, do: torch.Tensor, scale: float, h: int) -> torch.Tensor:
    """The tensor-core backward's rounding: p, dp, delta and ds in f32; p and
    ds rounded to bf16 as operands of dv, dq and dk, each summed in f32."""
    q, k, v = A._split(qkv, h)
    g = do.float().view(q.shape)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", g, v)
    delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    pb, dsb = _bf16(p), _bf16(ds)
    dv = torch.einsum("bhnm,bnhd->bmhd", pb, g)
    dq = torch.einsum("bhnm,bmhd->bnhd", dsb, k) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", dsb, q) * scale
    return torch.stack((dq, dk, dv), dim=2).reshape(qkv.shape).to(torch.bfloat16)


def emulate_split(qkv: torch.Tensor, do: torch.Tensor, scale: float, h: int):
    """K12a's and K12b's rounding: dq from bf16 ds, dk from bf16 ds, dv from
    bf16 p, each summed in f32 from p, dp, delta and ds recomputed in f32.
    Returns ``(dq, dkv)``: ``(B, N, W)`` and ``[dk | dv]``, ``(B, N, 2W)``."""
    q, k, v = A._split(qkv, h)
    g = do.float().view(q.shape)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", g, v)
    dsb = _bf16(p * (dp - (dp * p).sum(-1, keepdim=True)))
    dq = torch.einsum("bhnm,bmhd->bnhd", dsb, k) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", dsb, q) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", _bf16(p), g)
    return (dq.reshape(do.shape).to(torch.bfloat16),
            torch.cat([dk.reshape(do.shape), dv.reshape(do.shape)], dim=2).to(torch.bfloat16))


def _hi_lo(x: torch.Tensor):
    """float32 x as the pair of bfloat16 values ``(bf16(x), bf16(x - hi))``."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def emulate_fwd_T(qkv: torch.Tensor, scale: float, h: int) -> torch.Tensor:
    """K10's rounding on the tensor cores: s and softmax in f32, p split
    into hi and lo, ``hi @ v + lo @ v`` summed in f32, out in bf16."""
    q, k, v = A._split(qkv, h)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    o = sum(torch.einsum("bhnm,bmhd->bnhd", part, v) for part in _hi_lo(p))
    return o.reshape(qkv.shape[0], qkv.shape[1], -1).to(torch.bfloat16)


def emulate_bwd_T(qkv: torch.Tensor, do: torch.Tensor, scale: float, h: int) -> torch.Tensor:
    """K11's rounding on the tensor cores: p, dp, delta and ds in f32; p and
    ds split into hi and lo as operands of dv, dq and dk, each product summed
    in f32 over both parts."""
    q, k, v = A._split(qkv, h)
    g = do.float().view(q.shape)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dv = sum(torch.einsum("bhnm,bnhd->bmhd", part, g) for part in _hi_lo(p))
    dq = sum(torch.einsum("bhnm,bmhd->bnhd", part, k) for part in _hi_lo(ds)) * scale
    dk = sum(torch.einsum("bhnm,bnhd->bmhd", part, q) for part in _hi_lo(ds)) * scale
    return torch.stack((dq, dk, dv), dim=2).reshape(qkv.shape).to(torch.bfloat16)


def _within_bf16_tol(got: torch.Tensor, want: torch.Tensor, name: str) -> None:
    """``|got - want| <= atol * max|want| + rtol * |want|``, chip_smoke's rule."""
    got, want = got.float(), want.float()
    atol, rtol = BF16_TOL
    err = (got - want).abs()
    bound = atol * want.abs().max() + rtol * want.abs()
    assert torch.isfinite(got).all(), name
    assert (err <= bound).all(), f"{name}: max abs err {float(err.max()):.3e}"


@pytest.mark.parametrize("n,h,d", SHAPES, ids=SHAPE_IDS)
def test_forward_rounding_within_tolerance_of_plain(n, h, d):
    qkv, _ = _inputs(n, h, d, seed=n * h + d)
    x = torch.tensor(qkv).to(torch.bfloat16)
    scale = d ** -0.5
    _within_bf16_tol(emulate_fwd(x, scale, h), A.attention_qkv_plain(x, scale, h), "forward")


@pytest.mark.parametrize("n,h,d", SHAPES, ids=SHAPE_IDS)
def test_backward_rounding_within_tolerance_of_plain(n, h, d):
    """p and ds as bf16 operands stay within BF16_TOL of the f32 backward."""
    qkv, do = _inputs(n, h, d, seed=n * h + d + 1)
    x, g = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(do).to(torch.bfloat16)
    scale = d ** -0.5
    got = emulate_bwd(x, g, scale, h)
    want = A.attention_qkv_bwd_plain(x, g, scale, h)
    _within_bf16_tol(got, want, "backward")
    assert not torch.equal(got, want), "the operand rounding should move some gradient"


@pytest.mark.parametrize("n,h,d", JAX_SHAPES, ids=[f"n{n}h{h}d{d}" for n, h, d in JAX_SHAPES])
def test_rounding_within_tolerance_of_jax_in_bf16(n, h, d):
    """The JAX kernel on bfloat16 inputs (interpret mode on the CPU) against
    the emulated tensor-core rounding."""
    qkv, do = _inputs(n, h, d, seed=7 * n + d)
    scale = d ** -0.5
    out_ref, vjp = jax.vjp(lambda a: jax_attention_qkv(a, scale, h),
                           jnp.asarray(qkv, jnp.bfloat16))
    (dqkv_ref,) = vjp(jnp.asarray(do, jnp.bfloat16))
    x, g = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(do).to(torch.bfloat16)
    _within_bf16_tol(emulate_fwd(x, scale, h), torch.from_numpy(np.asarray(out_ref, np.float32)),
                     "forward")
    _within_bf16_tol(emulate_bwd(x, g, scale, h),
                     torch.from_numpy(np.asarray(dqkv_ref, np.float32)), "backward")


@pytest.mark.parametrize("n,h,d", SHAPES, ids=SHAPE_IDS)
def test_split_rounding_within_tolerance_of_plain(n, h, d):
    """K12a's and K12b's operand rounding stays within BF16_TOL of the split's
    float32 plain versions, and is K2's: the pair's result is emulate_bwd's."""
    qkv, do = _inputs(n, h, d, seed=n * h + d + 2)
    x, g = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(do).to(torch.bfloat16)
    scale = d ** -0.5
    dq, dkv = emulate_split(x, g, scale, h)
    _within_bf16_tol(dq, lab.split_dq_plain(x, g, scale, h), "K12a")
    _within_bf16_tol(dkv, lab.split_dkv_plain(x, g, scale, h), "K12b")
    assert torch.equal(torch.cat([dq, dkv], dim=2), emulate_bwd(x, g, scale, h))


@pytest.mark.parametrize("n,h,d", JAX_SHAPES, ids=[f"n{n}h{h}d{d}" for n, h, d in JAX_SHAPES])
def test_split_rounding_within_tolerance_of_jax_lab_in_bf16(monkeypatch, n, h, d):
    """The JAX lab's split (_dq_kernel, _dkv_kernel) on bfloat16 inputs in
    interpret mode against the emulated tensor-core rounding of K12a/K12b."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    qkv, do = _inputs(n, h, d, seed=5 * n + d)
    scale = d ** -0.5
    want = np.asarray(jax_lab.call_split(jnp.asarray(qkv, jnp.bfloat16),
                                         jnp.asarray(do, jnp.bfloat16), scale, h, 1), np.float32)
    x, g = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(do).to(torch.bfloat16)
    dq, dkv = emulate_split(x, g, scale, h)
    w = h * d
    _within_bf16_tol(dq, torch.from_numpy(want[..., :w]), "K12a")
    _within_bf16_tol(dkv, torch.from_numpy(want[..., w:]), "K12b")


@pytest.mark.parametrize("n,h,d", SHAPES, ids=SHAPE_IDS)
def test_lab_forward_rounding_within_tolerance_of_plain(n, h, d):
    qkv, _ = _inputs(n, h, d, seed=n * h + d + 3)
    x = torch.tensor(qkv).to(torch.bfloat16)
    scale = d ** -0.5
    _within_bf16_tol(emulate_fwd_T(x, scale, h), lab.fwd_T_plain(x, scale, h), "K10")


@pytest.mark.parametrize("n,h,d", SHAPES, ids=SHAPE_IDS)
def test_lab_backward_rounding_within_tolerance_of_plain(n, h, d):
    qkv, do = _inputs(n, h, d, seed=n * h + d + 4)
    x, g = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(do).to(torch.bfloat16)
    scale = d ** -0.5
    _within_bf16_tol(emulate_bwd_T(x, g, scale, h), lab.bwd_T_plain(x, g, scale, h), "K11")


@pytest.mark.parametrize("n,h,d", JAX_SHAPES, ids=[f"n{n}h{h}d{d}" for n, h, d in JAX_SHAPES])
def test_lab_rounding_within_tolerance_of_jax_lab_in_bf16(monkeypatch, n, h, d):
    """The JAX lab's ``_fwd_kernel_T`` and ``_bwd_kernel_T`` on bfloat16
    inputs in interpret mode against the emulated hi/lo rounding of K10/K11."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    qkv, do = _inputs(n, h, d, seed=3 * n + d)
    scale = d ** -0.5
    jqkv, jdo = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(do, jnp.bfloat16)
    want_fwd = jax_lab.call_fwd(jax_lab._fwd_kernel_T, jqkv, scale, h, 1)
    want_bwd = jax_lab.call_bwd(jax_lab._bwd_kernel_T, jqkv, jdo, scale, h, 1)
    x, g = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(do).to(torch.bfloat16)
    _within_bf16_tol(emulate_fwd_T(x, scale, h),
                     torch.from_numpy(np.asarray(want_fwd, np.float32)), "K10")
    _within_bf16_tol(emulate_bwd_T(x, g, scale, h),
                     torch.from_numpy(np.asarray(want_bwd, np.float32)), "K11")


@pytest.mark.parametrize("n,h,d", SHAPES, ids=SHAPE_IDS)
def test_lab_rounding_is_closer_to_f32_than_k1_k2(n, h, d):
    """Mean absolute error against the float32 function (the plain versions
    on float32 inputs, unrounded): the hi/lo pairs of K10 and K11 come
    strictly closer than the single bf16 operands of K1 and K2."""
    qkv, do = _inputs(n, h, d, seed=n * h + d + 5)
    x, g = torch.tensor(qkv).to(torch.bfloat16), torch.tensor(do).to(torch.bfloat16)
    scale = d ** -0.5

    def mean_err(got, want):
        return float((got.float() - want).abs().mean())

    fwd = lab.fwd_T_plain(x.float(), scale, h)
    assert mean_err(emulate_fwd_T(x, scale, h), fwd) < mean_err(emulate_fwd(x, scale, h), fwd)
    bwd = lab.bwd_T_plain(x.float(), g.float(), scale, h)
    assert (mean_err(emulate_bwd_T(x, g, scale, h), bwd)
            < mean_err(emulate_bwd(x, g, scale, h), bwd))
