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


# --- K3/K4's launch plan (computed on the host; the kernels run on the card) ---

# (rows, n, C, itemsize, shared mask): the stage shapes at the train batch and
# a scoring forward's, float32, the widest C, fewer rows than SMs, rows not a
# multiple of the tile, one row per example, the narrowest C
PLAN_SHAPES = [(512 * 257, 257, 256, 2, False), (512 * 65, 65, 512, 2, False),
               (512 * 17, 17, 1024, 2, False), (2048 * 17, 17, 1024, 2, False),
               (512 * 17, 17, 1024, 4, True), (64 * 9, 9, 2048, 2, False),
               (32 * 9, 9, 2048, 4, False), (3 * 5, 5, 96, 2, False),
               (7 * 17 + 0, 17, 1024, 2, False), (1000, 1, 8, 2, False),
               (77, 7, 100, 4, False)]
PLAN_IDS = ["stage1", "stage2", "stage3", "stage3_b2048", "stage3_f32_batch1", "c2048",
            "c2048_f32", "rows_lt_sms", "ragged", "n1", "c100_f32"]
SMS = 132


def block_tiles(plan, rows):
    """The tiles ``(start, stop)`` each block of a tiled plan walks, in order,
    as ``Walk`` in csrc/masked_ln.cu cuts them: an even share of the rows per
    block, in block order, cut into near-equal tiles of at most
    ``plan.tile_rows`` rows (the first ones a row longer where they cannot be
    equal)."""
    out = []
    for blk in range(plan.grid):
        b0, b1 = rows * blk // plan.grid, rows * (blk + 1) // plan.grid
        nt = -(-(b1 - b0) // plan.tile_rows)
        q, rem = divmod(b1 - b0, nt)
        starts = [b0 + j * q + min(j, rem) for j in range(nt + 1)]
        out.append(list(zip(starts, starts[1:])))
    return out


@pytest.mark.parametrize("backward", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("rows,n,c,itemsize,shared", PLAN_SHAPES, ids=PLAN_IDS)
def test_launch_plan_covers_every_row_once(rows, n, c, itemsize, shared, backward):
    from vit_search_torch.ops import masked_layer_norm as M

    plan = M.launch_plan(rows, n, c, itemsize, shared, True, SMS, backward)
    assert plan.tile_rows > 0, "16-byte rows on 16-byte boundaries take the tiled path"
    assert 1 <= plan.tile_rows <= M.MAX_TILE_ROWS
    assert 2 <= plan.stages <= M.RING_STAGES[backward]
    assert 1 <= plan.grid <= SMS * M.BLOCKS_PER_SM[backward]
    blocks = block_tiles(plan, rows)
    tiles = [t for block in blocks for t in block]
    assert len(blocks) == plan.grid and all(blocks)
    # every row once, in order; no block more than a row over another
    assert tiles[0][0] == 0 and tiles[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    shares = [block[-1][1] - block[0][0] for block in blocks]
    assert max(shares) - min(shares) <= 1
    for t0, t1 in tiles:
        assert 1 <= t1 - t0 <= plan.tile_rows
        # the mask rows a stage holds cover the tile's examples
        assert (1 if shared else (t1 - 1) // n - t0 // n + 1) <= plan.mask_rows


@pytest.mark.parametrize("backward", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("rows,n,c,itemsize,shared", PLAN_SHAPES, ids=PLAN_IDS)
def test_launch_plan_fits_shared_memory(rows, n, c, itemsize, shared, backward):
    from vit_search_torch.ops import masked_layer_norm as M

    plan = M.launch_plan(rows, n, c, itemsize, shared, True, SMS, backward)
    assert plan.smem_bytes == M.tiled_smem_bytes(backward, c, itemsize, plan.tile_rows,
                                                 plan.stages, plan.mask_rows)
    assert plan.smem_bytes <= M.MAX_BLOCK_SMEM == 227 * 1024
    # the persistent grid's blocks per SM fit in the SM together
    per_sm = -(-plan.grid // SMS)
    assert per_sm * (plan.smem_bytes + 1024) <= M.SM_SMEM
    # K4 folds its column sums in the ring's space
    if backward:
        phases = max(1, M.BLOCK_THREADS // (c // (16 // itemsize)))
        assert plan.smem_bytes >= phases * 2 * c * 4


@pytest.mark.parametrize("backward", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("c,itemsize,aligned", [(12, 2, True), (100, 2, True), (4, 2, True),
                                                (1024, 2, False), (256, 4, False)],
                         ids=["bf16_c12", "bf16_c100", "bf16_c4", "bf16_misaligned",
                              "f32_misaligned"])
def test_launch_plan_sends_the_rest_to_the_general_path(c, itemsize, aligned, backward):
    from vit_search_torch.ops import masked_layer_norm as M

    rows = 40 * 17
    plan = M.launch_plan(rows, 17, c, itemsize, False, aligned, SMS, backward)
    assert plan.tile_rows == 0 and plan.stages == 0
    if backward:   # one partial per block of the grid-stride rows
        assert plan.grid == min(-(-rows // 8), 4 * SMS)
        assert plan.smem_bytes == 2 * c * 4
    else:          # a warp per row
        assert plan.grid == -(-rows // 8)
