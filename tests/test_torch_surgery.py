"""The port's parameter surgery against the JAX package's, same weights.

``interpolate_pos_embeds`` is held to ``jax.image.resize(..., "bicubic")``
within 1e-5 on growing and shrinking grids (the JAX package's kernel is
Keys' a = -0.5 with antialiasing on a shrink; ``F.interpolate``'s bicubic,
a = -0.75, is another function, and a test shows it would fail here).
``slice_subnet_params`` and ``rewire_params`` are held to the JAX functions
bit for bit (they move values, they compute none), and the supernet ==
sliced-subnet equivalence of tests/test_models.py holds on the port's model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.models import surgery as jax_surgery
from vit_search_torch.convert import from_jax
from vit_search_torch.models import (SupernetSchedules, VisionTransformerSR,
                                     available_models, build_arch_masks, create_model,
                                     interpolate_pos_embeds, is_supernet_model,
                                     rewire_params, slice_subnet_params)
from vit_search_torch.models.surgery import resize_grid

from test_torch_model import NET

# tests/test_models.py's supernet, a candidate in its space, and the space
SUPER = ((0, 16),
         (1, (16, 4, 4), (16, 32), 1),
         (1, (16, 4, 4), (16, 32), 1),
         (3, 16, 32),
         (1, (32, 4, 8), (32, 64), 1),
         (2, 32, 10))
SUB = ((0, 12),
       (1, (12, 2, 4), (12, 16), 1),
       (1, (12, 2, 4), (12, 16), 0),
       (3, 12, 24),
       (1, (24, 2, 8), (24, 32), 1),
       (2, 24, 10))
SPACE = [np.array([16, 12, 8]),
         {"attn": np.array([16, 8]), "mlp": np.array([32, 16]), "layer": None},
         {"attn": np.array([16, 8]), "mlp": np.array([32, 16]), "layer": np.array([16, 0])},
         np.array([32, 24]),
         {"attn": np.array([32, 16]), "mlp": np.array([64, 32]), "layer": None},
         None]
IMG, PATCH = 28, 7
RESIZE_TOL = 1e-5


def _jax_resize(grid: np.ndarray, dst: int) -> np.ndarray:
    return np.asarray(jax.image.resize(jnp.asarray(grid)[None], (1, dst, dst, grid.shape[-1]),
                                       "bicubic"))[0]


@pytest.mark.parametrize("src,dst", [(16, 28), (8, 14), (4, 7), (1, 2), (28, 16), (14, 8)],
                         ids=["16to28", "8to14", "4to7", "1to2", "shrink28to16",
                              "shrink14to8"])
def test_resize_matches_jax(src, dst):
    grid = np.random.default_rng(src + dst).normal(size=(src, src, 24)).astype(np.float32)
    got = resize_grid(torch.tensor(grid), dst).numpy()
    np.testing.assert_allclose(got, _jax_resize(grid, dst), rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("src,dst", [(16, 28), (28, 16)], ids=["grow", "shrink"])
def test_f_interpolate_is_not_the_jax_resize(src, dst):
    """The trap: torch's bicubic (a = -0.75, no antialiasing) misses the JAX
    package's resize by far more than the tolerance; the port's does not."""
    grid = np.random.default_rng(0).normal(size=(src, src, 8)).astype(np.float32)
    want = _jax_resize(grid, dst)
    theirs = F.interpolate(torch.tensor(grid).permute(2, 0, 1)[None], size=(dst, dst),
                           mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
    assert np.abs(theirs - want).max() > 1000 * RESIZE_TOL
    assert np.abs(resize_grid(torch.tensor(grid), dst).numpy() - want).max() <= RESIZE_TOL


def _jax_params(net, img, patch, seed, **kw):
    model = JaxViT(network_def=net, img_size=img, patch_size=patch, num_classes=10, **kw)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
    return (model, jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables.get("batch_stats", {})))


def _tensors(sd):
    return {k: torch.tensor(np.array(v)) for k, v in sd.items()}


# (network_def, patch, source px, target px, distill token): a linear stem at
# 28 -> 56 px (grids 4 -> 8 and 2 -> 4), the conv-stem net at 56 -> 112 px
# (4 -> 8, 2 -> 4, 1 -> 2), the distill-token net's two token rows, and the
# conv-stem net shrunk 112 -> 56 px
INTERP_CASES = {"linear_stem_grow": (SUPER, 7, 28, 56, False),
                "conv_stem_grow": (NET, 14, 56, 112, False),
                "distill_tokens_grow": (SUPER, 7, 28, 56, True),
                "conv_stem_shrink": (NET, 14, 112, 56, False)}


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolate_pos_embeds_matches_jax(case):
    net, patch, src_px, dst_px, distill = INTERP_CASES[case]
    _, src, _ = _jax_params(net, src_px, patch, 0, distill_token=distill)
    _, dst, stats = _jax_params(net, dst_px, patch, 1, distill_token=distill)
    tokens = 2 if distill else 1
    want = from_jax(jax_surgery.interpolate_pos_embeds(src, dst, tokens), stats, net)

    model = VisionTransformerSR(net, img_size=dst_px, patch_size=patch, num_classes=10,
                                distill_token=distill, device="cpu")
    src_sd = _tensors(from_jax(src, None, net))
    got = interpolate_pos_embeds(src_sd, dict(model.named_parameters()), model.num_tokens)
    assert sorted(got) == sorted(n for n, _ in model.named_parameters())
    resized = [k for k in got if k.endswith("pos_embed")]
    assert all(got[k].shape != src_sd[k].shape for k in resized) and len(resized) == (
        3 if net is NET else 2)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=RESIZE_TOL, err_msg=k)
    # the token rows are copied bit for bit; the model runs on the result
    assert torch.equal(got["pos_embed"][:, :tokens], src_sd["pos_embed"][:, :tokens])
    model.load_state_dict({**got, **dict(model.named_buffers())})
    out = model.eval()(torch.ones(1, dst_px, dst_px, 3))
    assert torch.isfinite(out if not distill else out[0]).all()


def test_interpolate_pos_embeds_refuses_mismatches():
    _, src, _ = _jax_params(SUPER, 28, 7, 0)
    src_sd = _tensors(from_jax(src, None, SUPER))
    dst = dict(VisionTransformerSR(SUPER, img_size=56, patch_size=7, num_classes=10,
                                   device="cpu").named_parameters())
    with pytest.raises(KeyError, match="missing in source"):
        interpolate_pos_embeds({k: v for k, v in src_sd.items() if k != "norm.weight"},
                               dst, 1)
    bad = dict(src_sd, **{"cls_head.weight": torch.zeros(10, 7)})
    with pytest.raises(ValueError, match="shape mismatch at cls_head.weight"):
        interpolate_pos_embeds(bad, dst, 1)


def test_slice_subnet_params_matches_jax():
    _, sup, _ = _jax_params(SUPER, IMG, PATCH, 3)
    _, sub, _ = _jax_params(SUB, IMG, PATCH, 4)
    want = from_jax(jax_surgery.slice_subnet_params(sup, sub), None, SUB)
    got = slice_subnet_params(_tensors(from_jax(sup, None, SUPER)),
                              _tensors(from_jax(sub, None, SUB)))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # each q/k/v third is cut on its own: rows 0:8, 16:24, 32:40 of (48, 16)
    full = from_jax(sup, None, SUPER)["blocks.0.attn.qkv.weight"]
    np.testing.assert_array_equal(got["blocks.0.attn.qkv.weight"][8:16].numpy(),
                                  full[16:24, :12])


def test_slice_subnet_params_refuses_missing_entries():
    sup = {"a.weight": torch.zeros(4, 4)}
    with pytest.raises(KeyError, match="b.weight"):
        slice_subnet_params(sup, {"b.weight": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="rank mismatch"):
        slice_subnet_params(sup, {"a.weight": torch.zeros(2)})


@pytest.mark.parametrize("net,img,patch", [(SUPER, IMG, PATCH), (NET, 56, 14)],
                         ids=["linear_stem", "conv_stem"])
def test_rewire_params_matches_jax(net, img, patch):
    _, params, _ = _jax_params(net, img, patch, 5)
    want = from_jax(jax_surgery.rewire_params(params, net), None, net)
    sd = _tensors(from_jax(params, None, net))
    got = rewire_params(sd, net)
    moved = 0
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        moved += not torch.equal(v, sd[k])
    assert moved > 0


def _port_model(net, seed):
    return VisionTransformerSR(net, img_size=IMG, patch_size=PATCH, num_classes=10,
                               device="cpu", seed=seed)


@pytest.mark.parametrize("rewired", [False, True], ids=["as_trained", "after_rewiring"])
def test_supernet_equals_sliced_subnet(rewired):
    """tests/test_models.py::test_supernet_equals_sliced_subnet and
    ``_after_rewiring`` on the port's model."""
    batch = 4
    x = torch.randn(batch, IMG, IMG, 3, generator=torch.Generator().manual_seed(7))
    supernet, subnet = _port_model(SUPER, 3), _port_model(SUB, 4)
    super_sd = dict(supernet.named_parameters())
    if rewired:
        super_sd = rewire_params({k: v.detach() for k, v in super_sd.items()}, SUPER)
        supernet.load_state_dict(super_sd)
    subnet.load_state_dict(slice_subnet_params(super_sd, dict(subnet.named_parameters())))
    sched = SupernetSchedules(SUPER, SPACE, example_per_arch=batch, num_warmup_epochs=0,
                              arch_mode="multi")
    masks = build_arch_masks(sched.counts_for_subnets([SUB]), SUPER, batch)
    with torch.no_grad():
        masked = supernet.eval()(x, masks)
        dense = subnet.eval()(x)
    np.testing.assert_allclose(masked.numpy(), dense.numpy(), rtol=2e-4, atol=2e-5)


def test_rewiring_preserves_dense_function():
    model = _port_model(SUPER, 0).eval()
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = model(x)
        model.load_state_dict(rewire_params(
            {k: v.detach() for k, v in model.named_parameters()}, SUPER))
        after = model(x)
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("px", [280, 336, 392])
def test_finetune_names_build_their_resolution(px):
    name = f"flexible_vit_sr_patch14_{px}_patch_output"
    assert name in available_models() and not is_supernet_model(name)
    model = create_model(name, network_def=NET, num_classes=10, device="cpu")
    grid = px // 14
    assert model.pos_embed.shape == (1, grid * grid + 1, 32) and model.patch_output
    assert model.blocks[2].pos_embed.shape == (1, (grid // 2) ** 2, 64)
    assert is_supernet_model("flexible_vit_sr_patch14_224_patch_output_supernet")
