"""Channel masks, keep-count schedules and stochastic depth: port vs JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.arch import presets as jax_presets
from vit_search_tpu.arch import spaces as jax_spaces
from vit_search_tpu.models.supernet import SupernetSchedules as JaxSchedules
from vit_search_tpu.models.supernet import build_arch_masks as jax_build_arch_masks
from vit_search_tpu.ops.drop_path import drop_path as jax_drop_path
from vit_search_tpu.ops.masking import expand_arch_counts as jax_expand
from vit_search_tpu.ops.masking import make_channel_mask as jax_make_mask
from vit_search_torch.arch import presets, spaces
from vit_search_torch.models.supernet import SupernetSchedules, build_arch_masks
from vit_search_torch.ops.drop_path import drop_path
from vit_search_torch.ops.masking import expand_arch_counts, make_channel_mask


def test_make_channel_mask_matches_jax():
    counts = np.array([0, 3, 16, 9, 1], np.int32)
    got = make_channel_mask(torch.tensor(counts), 16)
    want = jax_make_mask(jnp.asarray(counts), 16)
    assert got.dtype == torch.bool and got.shape == (5, 1, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_expand_arch_counts_is_round_robin():
    counts = np.array([7, 5, 3], np.int32)
    got = expand_arch_counts(torch.tensor(counts), 9).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_expand(jnp.asarray(counts), 9)))
    assert [got[b] for b in range(9)] == [counts[b % 3] for b in range(9)]
    with pytest.raises(ValueError):
        expand_arch_counts(torch.tensor(counts), 8)


def test_arch_copies_match_jax():
    assert presets.PRESETS == jax_presets.PRESETS
    # the port's own names: other test files register extra spaces in the
    # JAX registry (test_cli_e2e.py), which may share this process
    assert set(spaces.available_spaces()) <= set(jax_spaces.available_spaces())
    for name in spaces.available_spaces():
        for a, b in zip(spaces.get_space(name), jax_spaces.get_space(name)):
            if isinstance(b, dict):
                assert a.keys() == b.keys()
                for k in b:
                    np.testing.assert_array_equal(a[k] if a[k] is not None else -1,
                                                  b[k] if b[k] is not None else -1)
            else:
                np.testing.assert_array_equal(a if a is not None else -1,
                                              b if b is not None else -1)


@pytest.mark.parametrize("arch_mode", ["single", "hybrid", "multi"])
def test_schedules_sample_pack_unpack_match_jax(arch_mode):
    net = presets.SUPERNET_SR_TINY_MH
    space = spaces.get_space("sr_tiny_mh")
    batch = 64
    ours = SupernetSchedules(net, space, example_per_arch=8, num_warmup_epochs=0,
                             arch_mode=arch_mode)
    theirs = JaxSchedules(jax_presets.SUPERNET_SR_TINY_MH, jax_spaces.get_space("sr_tiny_mh"),
                          example_per_arch=8, num_warmup_epochs=0, arch_mode=arch_mode)
    assert ours.packed_layout(batch) == theirs.packed_layout(batch)
    packed = ours.sample_packed(np.random.default_rng(3), batch)
    np.testing.assert_array_equal(packed, theirs.sample_packed(np.random.default_rng(3), batch))

    counts = ours.unpack(torch.tensor(packed), batch)
    np.testing.assert_array_equal(ours.pack(counts, batch), packed)
    got = build_arch_masks(counts, net, batch)
    want = jax_build_arch_masks(theirs.unpack(jnp.asarray(packed), batch),
                                jax_presets.SUPERNET_SR_TINY_MH, batch)
    np.testing.assert_array_equal(got["embed"].numpy(), np.asarray(want["embed"]))
    assert got["slots"].keys() == want["slots"].keys()
    for slot, site in want["slots"].items():
        assert got["slots"][slot].keys() == site.keys()
        for key, m in site.items():
            np.testing.assert_array_equal(got["slots"][slot][key].numpy(), np.asarray(m),
                                          err_msg=f"slot {slot} {key}")


def test_warmup_schedule_matches_jax():
    space = spaces.get_space("sr_tiny_mh")
    ours = SupernetSchedules(presets.SUPERNET_SR_TINY_MH, space, example_per_arch=4,
                             num_warmup_epochs=15)
    theirs = JaxSchedules(jax_presets.SUPERNET_SR_TINY_MH, jax_spaces.get_space("sr_tiny_mh"),
                          example_per_arch=4, num_warmup_epochs=15)
    for epoch in (0, 3, 15):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        np.testing.assert_array_equal(ours.sample_packed(np.random.default_rng(epoch), 16),
                                      theirs.sample_packed(np.random.default_rng(epoch), 16))


def test_drop_path_with_injected_keeps_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 4)).astype(np.float32)
    rate = 0.3
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_drop_path(jnp.asarray(x), rate, key, deterministic=False))
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate, shape=(6, 1, 1)))[:, 0, 0]
    got = drop_path(torch.tensor(x), rate, True, keep=torch.tensor(keep))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert drop_path(torch.tensor(x), rate, False) is not None
    np.testing.assert_array_equal(drop_path(torch.tensor(x), rate, False).numpy(), x)


def test_drop_path_generator_draws_are_reproducible():
    x = torch.ones(64, 3, 2)
    a = drop_path(x, 0.5, True, generator=torch.Generator().manual_seed(1))
    b = drop_path(x, 0.5, True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
