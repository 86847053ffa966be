"""The port's timm Mixup/CutMix against the JAX package's, same draws.

The JAX function derives its mixing weights, mixup/CutMix choices and boxes
from its key (vit_search_tpu/data/mixup.py:118-240); ``jax_mixup_draws``
rebuilds them with the same key splits and formulas (the weights and choices
through the JAX package's own ``_sample_mix_params``), and the port takes
them as a ``MixupDraws``. Mixed images and targets must agree within 1e-6.
The host sampler is held to the bounds tests/test_data.py holds the JAX
draws to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.data import mixup as jax_mixup
from vit_search_torch.data import MixupDraws, mixup_cutmix, sample_mixup_draws

MINMAX = (0.25, 0.75)
# (mixup_alpha, cutmix_alpha, switch_prob, mixup_prob, cutmix_minmax)
CONFIGS = {"default": (0.8, 1.0, 0.5, 1.0, None),
           "minmax": (0.8, 1.0, 0.5, 1.0, MINMAX),
           "prob_half": (0.8, 1.0, 0.5, 0.5, None),
           "mixup_only": (0.8, 0.0, 0.5, 1.0, None),
           "cutmix_only": (0.0, 1.0, 0.5, 1.0, None)}


def _jax_box(key, h, w, lam, minmax):
    """The corners ``_cutmix_box`` computes from ``key`` (mixup.py:145-178)."""
    k_a, k_b, k_c, k_d = jax.random.split(key, 4)
    if minmax is not None:
        lo, hi = minmax
        ch = jax.random.randint(k_a, (), int(h * lo), int(h * hi))
        cw = jax.random.randint(k_b, (), int(w * lo), int(w * hi))
        y0 = jax.random.randint(k_c, (), 0, h - ch)
        x0 = jax.random.randint(k_d, (), 0, w - cw)
        return int(y0), int(y0 + ch), int(x0), int(x0 + cw)
    cut_rat = jnp.sqrt(1.0 - lam)
    ch = (h * cut_rat).astype(jnp.int32)
    cw = (w * cut_rat).astype(jnp.int32)
    cy = jax.random.randint(k_a, (), 0, h)
    cx = jax.random.randint(k_b, (), 0, w)
    return (int(jnp.clip(cy - ch // 2, 0, h)), int(jnp.clip(cy + ch // 2, 0, h)),
            int(jnp.clip(cx - cw // 2, 0, w)), int(jnp.clip(cx + cw // 2, 0, w)))


def jax_mixup_draws(key, b, h, w, mixup_alpha, cutmix_alpha, switch_prob, mixup_prob,
                    mode, cutmix_minmax):
    """The draws ``mixup_cutmix(key, ...)`` makes for a batch of ``b`` images
    of ``h`` x ``w``."""
    if cutmix_minmax is not None:
        cutmix_alpha = 1.0
    k_params, k_box = jax.random.split(key)
    if mode == "batch":
        lam0, use = jax_mixup._sample_mix_params(k_params, (), mixup_alpha, cutmix_alpha,
                                                 switch_prob, mixup_prob)
        return MixupDraws(np.float32(lam0), bool(use),
                          *_jax_box(k_box, h, w, lam0, cutmix_minmax))
    n = b // 2 if mode == "pair" else b
    lam0, use = jax_mixup._sample_mix_params(k_params, (n,), mixup_alpha, cutmix_alpha,
                                             switch_prob, mixup_prob)
    boxes = np.array([_jax_box(k, h, w, l, cutmix_minmax)
                      for k, l in zip(jax.random.split(k_box, n), lam0)])
    lam0, use = np.asarray(lam0), np.asarray(use)
    if mode == "pair":
        lam0, use, boxes = (np.concatenate([a, a[::-1]]) for a in (lam0, use, boxes))
    return MixupDraws(lam0, use, *boxes.T)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["batch", "elem", "pair"])
def test_mixup_cutmix_matches_jax(mode, config):
    mixup_alpha, cutmix_alpha, switch_prob, mixup_prob, minmax = CONFIGS[config]
    b, h, w, classes = 8, 16, 12, 5
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    labels = rng.integers(0, classes, b)
    seen = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want_x, want_t = jax_mixup.mixup_cutmix(
            key, jnp.asarray(x), jnp.asarray(labels), classes, mixup_alpha, cutmix_alpha,
            switch_prob, 0.1, mixup_prob, mode=mode, cutmix_minmax=minmax)
        draws = jax_mixup_draws(key, b, h, w, mixup_alpha, cutmix_alpha, switch_prob,
                                mixup_prob, mode, minmax)
        got_x, got_t = mixup_cutmix(torch.tensor(x), torch.tensor(labels), classes,
                                    mixup_alpha, cutmix_alpha, switch_prob, 0.1, mixup_prob,
                                    mode=mode, cutmix_minmax=minmax, draws=draws)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-6)
        seen.update(zip(np.ravel(draws.use_cutmix).tolist(),
                        (np.ravel(draws.lam0) == 1.0).tolist()))
    # the six keys drew every branch the configuration allows
    if config == "default":
        assert {(True, False), (False, False)} <= seen
    if config == "prob_half":
        assert any(skipped for _, skipped in seen) and not all(s for _, s in seen)


def test_mixup_cutmix_on_bfloat16_images_matches_jax():
    """Mixing bf16 images promotes to float32 on both sides, as the lam blend
    of the JAX function does."""
    b, h, w = 6, 8, 8
    x = np.random.default_rng(0).normal(size=(b, h, w, 3)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    labels = np.arange(b) % 3
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want, _ = jax_mixup.mixup_cutmix(key, xb, jnp.asarray(labels), 3, mode="elem")
        draws = jax_mixup_draws(key, b, h, w, 0.8, 1.0, 0.5, 1.0, "elem", None)
        got, _ = mixup_cutmix(torch.tensor(x).bfloat16(), torch.tensor(labels), 3,
                              mode="elem", draws=draws)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _per_image_values(b=8, size=16):
    """Image i is the constant i, so mixes are readable."""
    x = torch.arange(b, dtype=torch.float32).view(b, 1, 1, 1).expand(b, size, size, 3)
    return x.contiguous(), torch.arange(b) % 4


@pytest.mark.parametrize("mode", ["batch", "elem", "pair"])
def test_mixup_partner_is_the_flipped_batch(mode):
    """tests/test_data.py::test_mixup_partner_is_flipped_batch on the port,
    its draws from the host sampler."""
    x, y = _per_image_values()
    b = x.shape[0]
    for seed in range(4):
        mixed, targets = mixup_cutmix(x, y, 4, mode=mode, rng=np.random.default_rng(seed))
        for i in range(b):
            lo, hi = sorted((i, b - 1 - i))
            assert mixed[i].min() >= lo - 1e-5 and mixed[i].max() <= hi + 1e-5
        np.testing.assert_allclose(targets.sum(-1).numpy(), 1.0, atol=1e-5)


def test_elem_mode_varies_per_example_and_pair_mode_mirrors():
    """tests/test_data.py::test_mixup_elem_mode_varies_per_example on the port."""
    x, y = _per_image_values(b=16)
    b = x.shape[0]
    m, _ = mixup_cutmix(x, y, 4, mode="elem", cutmix_alpha=0.0, rng=np.random.default_rng(0))
    lams = [(float(m[i].mean()) - (b - 1 - i)) / (2 * i - b + 1) for i in range(b)
            if 2 * i != b - 1]
    assert np.std(lams) > 1e-3
    mp, _ = mixup_cutmix(x, y, 4, mode="pair", cutmix_alpha=0.0, rng=np.random.default_rng(0))
    for i in range(b // 2):
        j = b - 1 - i
        lam_i = (float(mp[i].mean()) - j) / (i - j)
        lam_j = (float(mp[j].mean()) - i) / (j - i)
        np.testing.assert_allclose(lam_i, lam_j, atol=1e-5)


def test_host_sampler_bounds():
    """The draws stay inside the image, the weights in [0, 1], the switch
    near its probability, pair mode mirrored; the box of a default draw
    covers about ``1 - lam0`` of the image."""
    b, h, w = 4000, 32, 24
    d = sample_mixup_draws(np.random.default_rng(0), b, h, w, mode="elem")
    for lo, hi, size in ((d.y0, d.y1, h), (d.x0, d.x1, w)):
        assert (lo >= 0).all() and (hi <= size).all() and (lo <= hi).all()
    assert ((d.lam0 >= 0) & (d.lam0 <= 1)).all() and d.lam0.dtype == np.float32
    assert 0.45 < d.use_cutmix.mean() < 0.55
    area = (d.y1 - d.y0) * (d.x1 - d.x0) / (h * w)
    inner = (d.y0 > 0) & (d.y1 < h) & (d.x0 > 0) & (d.x1 < w)
    np.testing.assert_allclose(area[inner], 1 - d.lam0[inner], atol=0.15)
    p = sample_mixup_draws(np.random.default_rng(1), 10, h, w, mode="pair")
    for a in (p.lam0, p.use_cutmix, p.y0, p.y1, p.x0, p.x1):
        np.testing.assert_array_equal(a, a[::-1])
    s = sample_mixup_draws(np.random.default_rng(2), 8, h, w)
    assert np.ndim(s.lam0) == 0 and np.ndim(s.y0) == 0
    gated = sample_mixup_draws(np.random.default_rng(3), 4000, h, w, mixup_prob=0.25,
                               mode="elem")
    assert 0.7 < (gated.lam0 == 1.0).mean() < 0.8


def test_cutmix_minmax_box_bounds():
    """tests/test_data.py::test_cutmix_minmax_box_bounds on the port: the
    box sides are uniform fractions in [lo, hi) and the box lies inside the
    image; minmax turns CutMix on whatever the alphas."""
    x, y = _per_image_values(b=8, size=32)
    for seed in range(8):
        mixed, _ = mixup_cutmix(x, y, 4, mixup_alpha=0.0, cutmix_alpha=0.0,
                                cutmix_minmax=MINMAX, switch_prob=1.0,
                                rng=np.random.default_rng(seed))
        for i in range(8):
            j = 8 - 1 - i
            patch = (mixed[i, :, :, 0] == j).numpy()
            assert patch.any()
            ys, xs = np.where(patch)
            bh, bw = ys.max() - ys.min() + 1, xs.max() - xs.min() + 1
            assert 32 * 0.25 <= bh < 32 * 0.75 + 1 and 32 * 0.25 <= bw < 32 * 0.75 + 1
            assert bh * bw == patch.sum()


def test_mixup_mode_validation():
    x, y = _per_image_values()
    with pytest.raises(ValueError, match="unknown mixup mode"):
        mixup_cutmix(x, y, 4, mode="banana", rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="even batch"):
        mixup_cutmix(x[:7], y[:7], 4, mode="pair", rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="draws or an rng"):
        mixup_cutmix(x, y, 4)
    with pytest.raises(ValueError, match="mixup_alpha/cutmix_alpha"):
        mixup_cutmix(x, y, 4, mixup_alpha=0.0, cutmix_alpha=0.0,
                     rng=np.random.default_rng(0))
