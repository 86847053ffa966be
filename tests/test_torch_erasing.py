"""The port's random erasing against the JAX package's, same draws.

The JAX function derives each image's apply flag, region count, boxes and
fill noise from its key (vit_search_tpu/data/erasing.py:36-68);
``jax_erasing_draws`` rebuilds them with the same key splits and formulas,
and the port takes them as an ``ErasingDraws``. Outputs must agree within
1e-6 (they move values, so they agree exactly in practice). The host
sampler is held to the bounds tests/test_data.py holds the JAX draws to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.data.erasing import random_erasing as jax_random_erasing
from vit_search_torch.data import ErasingDraws, random_erasing, sample_erasing_draws

AREA_RANGE, ASPECT_RANGE = (0.02, 1 / 3), (0.3, 3.3)


def jax_erasing_draws(key, shape, prob, mode, count):
    """The draws ``random_erasing(key, images, prob, mode=mode, count=count)``
    makes for images of ``shape`` (B, H, W, C)."""
    b, h, w, c = shape
    apply, regions, boxes, fills = [], [], [], []
    for k in jax.random.split(key, b):
        k_apply, k_count, k_regions = jax.random.split(k, 3)
        apply.append(bool(jax.random.uniform(k_apply) < prob))
        regions.append(int(jax.random.randint(k_count, (), 1, count + 1)))
        img_boxes, img_fills = [], []
        for k_region in jax.random.split(k_regions, count):
            k_area, k_aspect, k_y, k_x, k_noise = jax.random.split(k_region, 5)
            area = jax.random.uniform(k_area, minval=AREA_RANGE[0],
                                      maxval=AREA_RANGE[1]) * (h * w)
            aspect = jnp.exp(jax.random.uniform(k_aspect, minval=jnp.log(ASPECT_RANGE[0]),
                                                maxval=jnp.log(ASPECT_RANGE[1])))
            eh = jnp.clip(jnp.sqrt(area * aspect).astype(jnp.int32), 1, h)
            ew = jnp.clip(jnp.sqrt(area / aspect).astype(jnp.int32), 1, w)
            y0 = jax.random.randint(k_y, (), 0, jnp.maximum(1, h - eh + 1))
            x0 = jax.random.randint(k_x, (), 0, jnp.maximum(1, w - ew + 1))
            img_boxes.append([int(y0), int(x0), int(eh), int(ew)])
            fill_shape = (h, w, c) if mode == "pixel" else (c,)
            img_fills.append(np.asarray(jax.random.normal(k_noise, fill_shape)))
        boxes.append(img_boxes)
        fills.append(img_fills)
    fill = None
    if mode != "const":
        fill = torch.tensor(np.stack([np.stack([f[i] for f in fills]) for i in range(count)]))
    return ErasingDraws(np.array(apply), np.array(regions), np.array(boxes), fill)


@pytest.mark.parametrize("prob", [0.0, 1.0, 0.25])
@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("mode", ["pixel", "rand", "const"])
def test_random_erasing_matches_jax(mode, count, prob):
    shape = (8, 16, 12, 3)
    x = np.random.default_rng(count).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_random_erasing(key, jnp.asarray(x), prob, mode=mode, count=count))
    draws = jax_erasing_draws(key, shape, prob, mode, count)
    got = random_erasing(torch.tensor(x), prob, mode, count, draws=draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if prob == 1.0:
        assert (got != x).any()


def test_erasing_draws_stay_inside_the_image():
    b, h, w, count = 2000, 24, 40, 3
    d = sample_erasing_draws(np.random.default_rng(0), b, h, w, 0.25, count)
    y0, x0, eh, ew = np.moveaxis(d.boxes, -1, 0)
    assert d.boxes.shape == (b, count, 4)
    assert (eh >= 1).all() and (ew >= 1).all() and (eh <= h).all() and (ew <= w).all()
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + eh <= h).all() and (x0 + ew <= w).all()
    assert set(np.unique(d.regions)) == {1, 2, 3}
    assert 0.2 < d.apply.mean() < 0.3
    # areas about 2%-33% of the image; wide and tall boxes both occur
    frac = (eh * ew) / (h * w)
    assert frac.min() < 0.05 and frac.max() > 0.2 and (eh > ew).any() and (ew > eh).any()


def test_random_erasing_modes_and_count():
    """tests/test_data.py::test_random_erasing_modes_and_count on the port,
    its draws from the host sampler and the device generator."""
    x = torch.full((32, 16, 16, 3), 7.0)
    gen = torch.Generator().manual_seed(0)

    def erase(mode, count=1, seed=0):
        return random_erasing(x, 1.0, mode, count, rng=np.random.default_rng(seed),
                              generator=gen).numpy()

    out = erase("const")
    assert ((out == 0) | (out == 7)).all() and (out == 0).any()
    for img in erase("rand"):
        assert len(np.unique(img.reshape(-1, 3), axis=0)) <= 2
    assert len(np.unique(erase("pixel"))) > 32
    one, many = erase("const", 1), erase("const", 4)
    assert (many == 0).mean() >= (one == 0).mean() * 0.8
    with pytest.raises(ValueError, match="unknown erasing mode"):
        random_erasing(x, 0.5, "banana", rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="draws or an rng"):
        random_erasing(x, 0.5)


def test_random_erasing_prob_bounds():
    """tests/test_data.py::test_random_erasing_prob_bounds on the port."""
    x = torch.zeros(64, 16, 16, 3)
    out = random_erasing(x, 0.5, rng=np.random.default_rng(0),
                         generator=torch.Generator().manual_seed(0)).numpy()
    erased = np.abs(out).reshape(64, -1).max(axis=1) > 0
    assert 10 < erased.sum() < 55
    assert random_erasing(x, 0.0) is x
