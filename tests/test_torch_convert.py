"""Weights carried across: the port's ``convert`` against the JAX package's
``convert_state_dict``, and the port model's state-dict keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.tools.convert_torch import convert_state_dict
from vit_search_torch.convert import from_jax, load_jax, to_jax
from vit_search_torch.models import VisionTransformerSR

CONV_NET = ((4, 16),
            (1, (16, 2, 8), (16, 32), 1),
            (1, (16, 2, 8), (16, 32), 0),
            (3, 16, 32),
            (1, (32, 2, 16), (32, 64), 1),
            (2, 32, 4))
LINEAR_NET = ((0, 16),) + CONV_NET[1:]
CASES = {"conv_stem": (CONV_NET, 28, 14), "linear_stem": (LINEAR_NET, 28, 7)}


def _jax_vars(net, img, patch):
    model = JaxViT(network_def=net, img_size=img, patch_size=patch, num_classes=4,
                   patch_output=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(variables["params"]), to_np(variables.get("batch_stats", {}))


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(b, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_jax_inverts_convert_state_dict(case):
    net, img, patch = CASES[case]
    params, stats = _jax_vars(net, img, patch)
    sd = from_jax(params, stats, net)
    got_params, got_stats = convert_state_dict(sd, net)
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_stats, stats)


@pytest.mark.parametrize("case", sorted(CASES))
def test_to_jax_matches_convert_state_dict(case):
    net, img, patch = CASES[case]
    params, stats = _jax_vars(net, img, patch)
    sd = from_jax(params, stats, net)
    ours, theirs = to_jax(sd, net), convert_state_dict(sd, net)
    _assert_trees_equal(ours[0], theirs[0])
    _assert_trees_equal(ours[1], theirs[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_state_dict_keys_and_shapes(case):
    """The port's parameters carry the reference torch names, bypass slots
    included in the ``blocks.<j>`` count, and round-trip through JAX."""
    net, img, patch = CASES[case]
    params, stats = _jax_vars(net, img, patch)
    model = VisionTransformerSR(net, img_size=img, patch_size=patch, num_classes=4,
                                patch_output=True, device="cpu")
    sd = from_jax(params, stats, net)
    ours = model.state_dict()
    assert sorted(ours) == sorted(sd)
    for k, v in sd.items():
        assert tuple(ours[k].shape) == v.shape, k
    assert "blocks.1.norm1.weight" not in ours          # slot 2 is a bypass slot
    assert "blocks.3.attn.qkv.weight" in ours
    load_jax(model, params, stats)
    back_params, back_stats = to_jax(model.state_dict(), net)
    _assert_trees_equal(back_params, params)
    _assert_trees_equal(back_stats, stats)
