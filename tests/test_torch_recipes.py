"""The 24 published scripts of ``scripts/vit-sr-nas`` as the port runs them.

- What ``chip_smoke.py``'s ``recipes`` phase passes each script: parsed by
  the port's parsers, its arguments differ from the script's own only in the
  phase's overrides (``RECIPE_OVERRIDES``), and every script runs after the
  one whose checkpoint it reads.
- The port's forward against the JAX package's at every distinct (model
  name, network_def, search space) of the scripts, the network_def cut to
  one block per stage at the recipe's own widths and heads, at 56 px: the
  supernets masked by counts drawn from the recipe's space, the dense nets
  without masks. The weights go from the JAX model to the port through
  ``convert``; tolerances as in ``tests/test_torch_model.py``.
- One train step of the three supernets that the scripts train besides the
  Tiny ones (``sr_small_mh``, ``sr_small``, ``sr_tiny_666``) with the JAX
  step's draws injected: loss and gradient norm, as in
  ``tests/test_torch_train_step.py``.
- The training CLI writes ``best`` and ``best_ema`` after an evaluated epoch
  that scored 0%, so the chain's finetunes and eval find them.
- ``chip_smoke.py``'s kernel table: a row for every registered kernel, each
  case's net one whose launches the recipes phase counts, or none.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.arch import spaces as jax_spaces
from vit_search_tpu.models import create_model as jax_create_model
from vit_search_tpu.models import layers as jax_layers
from vit_search_tpu.models.supernet import SupernetSchedules as JaxSchedules
from vit_search_tpu.models.supernet import build_arch_masks as jax_build_arch_masks
from vit_search_tpu.train import OptimConfig as JaxOptimConfig
from vit_search_tpu.train import TrainConfig as JaxTrainConfig
from vit_search_tpu.train import TrainState
from vit_search_tpu.train import cosine_schedule as jax_schedule
from vit_search_tpu.train import make_optimizer as jax_make_optimizer
from vit_search_tpu.train import make_train_step as jax_make_train_step
from vit_search_torch.arch import network_def as nd
from vit_search_torch.arch import parse_network_def, spaces
from vit_search_torch.cli import evo_search as evo_cli
from vit_search_torch.cli import train as train_cli
from vit_search_torch.convert import load_jax
from vit_search_torch import train as train_pkg
from vit_search_torch.models import SupernetSchedules, build_arch_masks, create_model
from vit_search_torch.train import (OptimConfig, StepDraws, TrainConfig, lr_schedule,
                                    make_optimizer, make_train_step)

from test_torch_cli import _args as cli_args
from test_torch_cli import SUPERNET, folder  # noqa: F401  (the CLI's data fixture)
from test_torch_mixup_cutmix import jax_mixup_draws
from test_torch_train_step import _jax_token_mix_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SCRIPTS = sorted(os.path.relpath(os.path.join(d, f), os.path.join(REPO, chip_smoke.RECIPE_DIR))
                 for d, _, fs in os.walk(os.path.join(REPO, chip_smoke.RECIPE_DIR))
                 for f in fs if f.endswith(".sh"))
DATA = "/recipes/data"
IMG, BATCH = 56, 4


def _parser(cli):
    return (train_cli if cli == "train" else evo_cli).get_args_parser()


def _own(script):
    return chip_smoke.script_command(os.path.join(chip_smoke.RECIPE_DIR, script))


# --- what the recipes phase runs ------------------------------------------------

def test_the_phase_runs_the_24_scripts_once_each():
    assert len(SCRIPTS) == 24 and sorted(chip_smoke.RECIPES) == SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_recipe_arguments_are_the_scripts_own_but_for_the_overrides(script):
    cli, own = _own(script)
    got_cli, argv = chip_smoke.recipe_argv(script, DATA, 3)
    assert got_cli == cli
    parser = _parser(cli)
    allowed = {parser._option_string_actions[f].dest for f in chip_smoke.RECIPE_OVERRIDES
               if f in parser._option_string_actions}
    ours, theirs = vars(parser.parse_args(argv)), vars(_parser(cli).parse_args(own))
    assert {k for k in ours if ours[k] != theirs[k]} <= allowed
    assert ours["data_path"] == DATA and ours["num_workers"] == 3
    assert ours.get("output_dir") == theirs.get("output_dir")
    if cli == "evo_search":
        assert os.path.dirname(ours["model_path"]) == os.path.dirname(theirs["model_path"])
        assert os.path.basename(ours["model_path"]) == chip_smoke.RECIPE_CHECKPOINT
        assert [ours[_parser(cli)._option_string_actions[f].dest]
                for f in chip_smoke.RECIPE_SEARCH] == [int(v) for v in
                                                        chip_smoke.RECIPE_SEARCH.values()]
        assert ours["constraint_value"] == theirs["constraint_value"]
    elif not ours["eval"]:
        assert (ours["epochs"], ours["max_steps_per_epoch"]) == (chip_smoke.RECIPE_EPOCHS,
                                                                 chip_smoke.RECIPE_STEPS)
    assert ours.get("batch_size") == chip_smoke.RECIPE_BATCH_CUTS.get(
        script, theirs.get("batch_size"))
    assert ours["val_bs"] == theirs["val_bs"]


def _writes(script, argv):
    """The checkpoints a recipe's run leaves: ``checkpoint`` and ``best``
    after its evaluated epoch, ``best_ema`` where it keeps an EMA."""
    args = _parser("train").parse_args(argv)
    if args.eval or not args.output_dir:
        return set()
    names = ["checkpoint", "best"] + (["best_ema"] if args.model_ema else [])
    return {os.path.join(args.output_dir, "checkpoints", n) for n in names}


def test_every_recipe_runs_after_the_checkpoints_it_reads():
    written, reads = set(), 0
    for script in chip_smoke.RECIPES:
        cli, argv = chip_smoke.recipe_argv(script, DATA, 3)
        for path in chip_smoke.recipe_reads(argv):
            assert path in written, f"{script} reads {path} before any recipe writes it"
            reads += 1
        if cli == "train":
            written |= _writes(script, argv)
    assert reads == 9   # six searches, two finetunes, the eval


@pytest.mark.parametrize("script,launches", [
    ("super_net/small.sh", (21, 45, 21, 45, 0, 0)),
    ("super_net/tiny.sh", (18, 39, 18, 39, 0, 0)),
    ("super_net/no_distill/tiny.sh", (18, 39, 18, 39, 0, 0)),
    ("evolutionary_search/medium_mac@4.6G.sh", (21, 45, 21, 45, 0, 0)),
    ("reference_net/tiny.sh", (12, 0, 12, 0, 27, 27)),
    ("finetune/medium_img-size@280.sh", (20, 0, 20, 0, 43, 43)),
    ("eval/small_mac@2.9G.sh", (17, 0, 17, 0, 37, 37)),
])
def test_recipe_launches_per_step_and_per_forward(script, launches):
    """K1/K2 on every attention block (N >= 8 at every stage of these nets);
    K3/K4 on a net's 2 x blocks + SR blocks + final layer norm, masked in a
    supernet, in their dense mode in a dense net, the other records 0."""
    cli, argv = chip_smoke.recipe_argv(script, DATA, 3)
    args = _parser(cli).parse_args(argv)
    masked = cli == "evo_search" or args.model.endswith("_supernet")
    net = parse_network_def(args.network_def)
    step, forward = chip_smoke.recipe_launches(net, args.input_size, masked,
                                               getattr(args, "drop_path", 0.0))
    assert (step["attention_qkv_fwd"], step["masked_layer_norm_fwd"],
            forward["attention_qkv_fwd"], forward["masked_layer_norm_fwd"],
            step["layer_norm_fwd"], forward["layer_norm_fwd"]) == launches
    assert step["attention_qkv_bwd"] == launches[0] and forward["attention_qkv_bwd"] == 0
    assert step["masked_layer_norm_bwd"] == launches[1]
    assert step["layer_norm_bwd"] == launches[4] and forward["layer_norm_bwd"] == 0
    # 2 x existing_depth + SR blocks + 1, masked or dense
    lns = 2 * nd.existing_depth(net) + nd.num_stages(net)
    assert launches[1] + launches[4] == lns
    assert set(step) == set(forward) == set(chip_smoke.KERNEL_NAMES)


@pytest.mark.parametrize("script,norms", [
    ("super_net/tiny.sh", 3),
    ("super_net/no_distill/tiny.sh", 0),
    ("super_net/no_distill/small_flexible-conv-patch.sh", 3),
    ("evolutionary_search/tiny.sh", 3),
    ("reference_net/tiny.sh", 3),
    ("finetune/medium_img-size@392.sh", 3),
])
def test_recipe_launches_count_the_conv_stem_norms(script, norms):
    """B1's statistics, normalize and B2 once per conv-stem norm a train
    step, the normalize alone an eval or scoring forward; none in a net with
    a linear stem."""
    cli, argv = chip_smoke.recipe_argv(script, DATA, 3)
    args = _parser(cli).parse_args(argv)
    masked = cli == "evo_search" or args.model.endswith("_supernet")
    net = parse_network_def(args.network_def)
    step, forward = chip_smoke.recipe_launches(net, args.input_size, masked,
                                               getattr(args, "drop_path", 0.0))
    names = ("batch_norm_stats", "batch_norm_apply", "batch_norm_bwd")
    assert tuple(step[k] for k in names) == (norms, norms, norms)
    assert tuple(forward[k] for k in names) == (0, norms, 0)
    assert chip_smoke.stem_norms(net) == norms


@pytest.mark.parametrize("script,step,forward", [
    ("super_net/tiny.sh", (18, 18, 36, 72), (18, 0, 36, 18)),
    ("evolutionary_search/tiny.sh", (18, 18, 36, 72), (18, 0, 36, 18)),
    ("super_net/small.sh", (21, 21, 42, 84), (21, 0, 42, 21)),
    ("searched_net/medium_mac@4.6G.sh", (0, 0, 38, 38), (0, 0, 0, 0)),
    ("finetune/medium_img-size@392.sh", (0, 0, 38, 38), (0, 0, 0, 0)),
    ("eval/small_mac@2.9G.sh", (0, 0, 32, 32), (0, 0, 0, 0)),
])
def test_recipe_launches_count_the_prefix_kernels(script, step, forward):
    """M1 (forward, backward), M2 and M3 a train step and an eval or scoring
    forward: in a supernet or a search every block's hidden and head masks
    and both branches; in a dense net M2 and M3 on each branch whose
    drop-path rate is above 0 (all but the first block's), none in eval."""
    net, size, masked, rate = chip_smoke.recipe_net(script)
    per_step, per_forward = chip_smoke.recipe_launches(net, size, masked, rate)
    names = ("prefix_gelu_fwd", "prefix_gelu_bwd", "branch_add", "prefix_scale")
    assert tuple(per_step[k] for k in names) == step
    assert tuple(per_forward[k] for k in names) == forward


@pytest.mark.parametrize("script,stages", [
    ("super_net/small.sh", [(257, 320, 8, 32), (65, 640, 16, 48), (17, 1280, 16, 64)]),
    ("super_net/no_distill/tiny.sh", [(257, 256, 4, 64), (65, 512, 8, 64), (17, 1024, 12, 64)]),
    ("reference_net/tiny.sh", [(257, 192, 3, 64), (65, 384, 6, 64), (17, 768, 12, 64)]),
    ("finetune/medium_img-size@280.sh", [(401, 240, 8, 32), (101, 640, 16, 48),
                                         (26, 880, 16, 64)]),
])
def test_recipe_kernel_shapes_come_from_the_network_def(script, stages):
    assert chip_smoke.recipe_stages(script) == stages


# --- the kernel table ----------------------------------------------------------------

def test_launch_tables_name_every_registered_kernel():
    """``KERNEL_NAMES``, the records ``recipe_launches`` counts, are the
    kernels the port registers once every ops module and the lab are
    imported."""
    import importlib
    import pkgutil

    from vit_search_torch import ops
    from vit_search_torch.ops import kernels
    from vit_search_torch.tools import attn_lab  # noqa: F401  (registers K10-K12)

    for mod in pkgutil.iter_modules(ops.__path__):
        importlib.import_module(f"vit_search_torch.ops.{mod.name}")
    assert sorted(chip_smoke.KERNEL_NAMES) == sorted(k.name for k in kernels.KERNELS)


def _case_kernels(case) -> tuple:
    """The kernel records a case of the table gives rows for, by its check
    and shape (the stem module's row is a model layer's, not a kernel's)."""
    if case.check == "attention":
        names = chip_smoke.ATTENTION_KERNELS[case.shape[4]]
        return names if len(case.shape) < 7 or case.shape[6] else names[:1]
    if case.check == "masked_ln":
        return ("masked_layer_norm_fwd", "masked_layer_norm_bwd")[:1 + case.shape[3]]
    if case.check == "prefix_mask":
        return (("prefix_gelu_fwd", "prefix_gelu_bwd", "branch_add", "prefix_scale")
                if case.shape[5] else ("branch_add", "prefix_scale"))
    if case.check == "stem_norm":
        return (("batch_norm_stats", "batch_norm_apply", "batch_norm_bwd") if case.shape[2]
                else ("batch_norm_apply",))
    return {"row_stats": ("row_sum_sumsq",), "lab": tuple(c[0] for c in chip_smoke.lab_cases()),
            "layer_norm": ("layer_norm_fwd", "layer_norm_bwd"), "stem_module": (),
            "window_attention": ("window_attention_fwd", "window_attention_bwd")}[case.check]


def test_the_table_covers_every_registered_kernel():
    """Every kernel has a row among ``cases()``; each case names a check,
    and its net is a script that the recipes phase runs (which counts the
    row's launches), DeiT-S, SwinV2-B, or none."""
    cases = chip_smoke.cases()
    rows = {name for case in cases for name in _case_kernels(case)}
    assert rows == set(chip_smoke.KERNEL_NAMES)
    for case in cases:
        assert case.check in chip_smoke.CHECKS, case
        assert case.net in (*chip_smoke.RECIPES, "DeiT-S", "SwinV2-B", None), case


# --- the CLI writes the checkpoints that the chain reads ------------------------------

def test_best_checkpoints_after_an_epoch_that_scored_zero(folder, tmp_path,  # noqa: F811
                                                          monkeypatch):
    """An evaluated epoch at 0% top-1 still leaves ``best`` and ``best_ema``
    (the finetune scripts read ``best_ema``, the eval script ``best``); the
    next evaluated epoch at 0% keeps them (no new maximum)."""
    make_eval_step = train_pkg.make_eval_step

    def zero_top1(model, device=None):
        step = make_eval_step(model, device=device)

        def eval_step(*args, **kwargs):
            metrics = step(*args, **kwargs)
            return {**metrics, "top1": metrics["top1"] * 0}
        return eval_step

    monkeypatch.setattr(train_pkg, "make_eval_step", zero_top1)
    out = str(tmp_path / "zero")
    result = train_cli.main(cli_args(folder, SUPERNET + ["--model-ema", "--output_dir", out]))
    assert result["test_acc1"] == 0.0 and result["ema_test_acc1"] == 0.0
    for name in ("checkpoint", "best", "best_ema"):
        assert os.path.isfile(os.path.join(out, "checkpoints", name, "state.pt")), name
    meta = train_pkg.restore_raw(os.path.join(out, "checkpoints", "best"))["metadata"]
    assert meta["epoch"] == 0    # written at the first epoch, kept at the second


def test_global_norm_matches_optax_at_the_small_supernets_widths():
    """The train step's gradient norm (``train.global_norm``) over gradients
    of the Small supernet's largest shapes (stage 3's MLP, 1280 x 3840, and
    the 1000-class head) against ``optax.global_norm`` and float64."""
    import optax

    rng = np.random.default_rng(0)
    grads = [(0.01 * rng.standard_normal(shape) + 0.003).astype(np.float32)
             for shape in ((3840, 1280), (1280, 3840), (1000, 1280), (1280,))]
    want = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    exact = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    got = train_pkg.global_norm([torch.tensor(g) for g in grads])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), exact, rtol=1e-6)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# --- parity with the JAX package at the recipes' widths -------------------------------

def _cut(net, space):
    """``net`` with one transformer block per stage (the first), and the
    entries of ``space`` that go with them."""
    keep, first = [], True
    for i, block in enumerate(net):
        if nd.block_type(block) == nd.TRANSFORMER:
            if first:
                keep.append(i)
            first = False
        else:
            keep.append(i)
            first = True
    return (tuple(net[i] for i in keep),
            None if space is None else [space[i] for i in keep])


def _config(script):
    """``(model, network_def, search space or None)`` of a script."""
    cli, argv = _own(script)
    args = _parser(cli).parse_args(argv)
    return args.model, args.network_def, args.search_space


def _distinct_configs():
    """``{script: config}``, each distinct config once, under the first
    script that has it."""
    out = {}
    for script in SCRIPTS:
        if _config(script) not in out.values():
            out[script] = _config(script)
    return out


CONFIGS = _distinct_configs()
SUPERNETS = {"super_net/small.sh": dict(mixup_mode="token", dpr=0.3),
             "super_net/no_distill/small_flexible-conv-patch.sh": dict(mixup_mode="token",
                                                                       dpr=0.3),
             "super_net/no_distill/tiny.sh": dict(mixup_mode="mixup", dpr=0.2)}


def test_the_distinct_configurations():
    """Five supernets (Tiny on two stems, Small, Small on the flexible conv
    stem, sr_tiny_666), their four searches' evaluator models, and the
    dense nets: searched Tiny, Small and Medium, the Medium finetunes at 280
    and 392 px, the reference net."""
    assert len(CONFIGS) == 15
    assert all(_config(script) in CONFIGS.values() for script in SUPERNETS)


def _weights(jmodel):
    """Weights in the JAX model's trees, drawn with numpy from a seed (the
    shapes from ``jax.eval_shape`` of its init, which compiles nothing):
    kernels N(0, 1/fan_in), layer-norm scales about 1, biases and
    embeddings about 0, BN running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        std = (np.prod(leaf.shape[:-1]) ** -0.5 if name.endswith("['kernel']")
               else 0.1 if name.endswith(("['bias']", "['mean']")) else 0.02)
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(draw, shapes)
    return out["params"], out.get("batch_stats", {})


@pytest.fixture
def no_port_init(monkeypatch):
    """The port's random init is overwritten by ``load_jax`` (every key,
    strictly): skip it."""
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", lambda t, **kwargs: t)


def _models(model, net_text, space_name, dpr=0.0):
    net, space = _cut(parse_network_def(net_text),
                      spaces.get_space(space_name) if space_name else None)
    jspace = (_cut(parse_network_def(net_text), jax_spaces.get_space(space_name))[1]
              if space_name else None)
    jmodel = jax_create_model(model, network_def=net, img_size=IMG, drop_path_rate=dpr)
    params, stats = _weights(jmodel)
    port = create_model(model, network_def=net, img_size=IMG, drop_path_rate=dpr, device="cpu")
    load_jax(port, params, stats)
    return net, space, jspace, jmodel, params, stats, port


_JAX_LOGITS = {}


@pytest.mark.parametrize("script", sorted(CONFIGS))
def test_recipe_forward_matches_jax(script, no_port_init):
    model, net_text, space_name = CONFIGS[script]
    net, space, jspace, jmodel, params, stats, port = _models(model, net_text, space_name)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    jax_masks = masks = None
    if space_name:
        counts = JaxSchedules(net, jspace, example_per_arch=2,
                              num_warmup_epochs=0).sample_packed(rng, BATCH)
        jax_masks = jax_build_arch_masks(JaxSchedules(net, jspace, 2, 0).unpack(
            jnp.asarray(counts), BATCH), net, BATCH)
        masks = build_arch_masks(SupernetSchedules(net, space, 2, 0).unpack(counts, BATCH),
                                 net, BATCH)
    # scripts whose names build the same JAX module (a supernet name and its
    # base name; the finetunes' names at 56 px) share one JAX forward
    key = (repr(jmodel), space_name)
    if key not in _JAX_LOGITS:
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        apply = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, deterministic=True))
        _JAX_LOGITS[key] = np.asarray(apply(variables, jnp.asarray(x), jax_masks))
    ref = _JAX_LOGITS[key]
    port.eval()
    with torch.no_grad():
        got = port(torch.tensor(x), masks)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("script", sorted(SUPERNETS))
def test_recipe_supernet_train_step_matches_jax(script, monkeypatch, no_port_init):
    """One step from the same weights, images, labels and keep counts drawn
    from the recipe's space, token mixup (patch 2 at 56 px) or timm
    Mixup/CutMix as the script trains, smoothing 0.1, the recipe's drop path
    with fixed keeps, AdamW; the JAX step's mixing draws rebuilt from its
    key."""
    model, net_text, space_name = _config(script)
    mode, dpr = SUPERNETS[script]["mixup_mode"], SUPERNETS[script]["dpr"]
    net, space, jspace, jmodel, params, stats, port = _models(model, net_text, space_name, dpr)
    classes, patch_len = net[-1][2], 2
    # the first block's drop path rate is 0: the others draw, attention then MLP
    keeps = [np.random.default_rng(7 + i).random(BATCH) < 1.0 - dpr
             for i in range(2 * (nd.existing_depth(net) - 1))]
    keeps[0][:1] = False
    calls = [0]

    def drop_path(x, rate, key, deterministic):
        keep = jnp.asarray(keeps[calls[0] % len(keeps)])
        calls[0] += 1
        return jnp.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)), x / (1.0 - rate),
                         jnp.zeros_like(x))

    monkeypatch.setattr(jax_layers, "_drop_path", drop_path)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    labels = rng.integers(0, classes, BATCH)
    mix = dict(mixup_mode=mode, smoothing=0.1, patch_len=patch_len)
    if mode == "mixup":   # the CLI's defaults, which the script keeps
        mix.update(mixup_alpha=0.8, cutmix_alpha=1.0, mixup_switch_prob=0.5, mixup_prob=1.0,
                   mixup_elem_mode="batch")

    jsched = JaxSchedules(net, jspace, example_per_arch=2, num_warmup_epochs=0)
    counts = jsched.sample_packed(np.random.default_rng(1), BATCH)
    jocfg = JaxOptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH)
    tx = jax_make_optimizer(jocfg, params)
    jstep = jax_make_train_step(jmodel, tx, JaxTrainConfig(num_classes=classes, **mix),
                                schedule=jax_schedule(jocfg), donate=False,
                                counts_unpack=jsched.unpack)
    key = jax.random.PRNGKey(42)
    _, jmetrics = jstep(TrainState.create(params, tx, stats), jnp.asarray(images),
                        jnp.asarray(labels), jnp.asarray(counts), key)
    k_mix = jax.random.split(jax.random.fold_in(key, 0), 4)[0]
    if mode == "token":
        mix_draws = {"mix": _jax_token_mix_draws(k_mix, BATCH, patch_len)}
    else:
        mix_draws = {"mixup": jax_mixup_draws(k_mix, BATCH, IMG, IMG, 0.8, 1.0, 0.5, 1.0,
                                              "batch", None)}

    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2, global_batch_size=BATCH)
    sched = SupernetSchedules(net, space, example_per_arch=2, num_warmup_epochs=0)
    step = make_train_step(port, make_optimizer(ocfg, port),
                           TrainConfig(num_classes=classes, **mix), schedule=lr_schedule(ocfg),
                           counts_unpack=sched.unpack, device="cpu")
    metrics = step(torch.tensor(images), torch.tensor(labels), counts,
                   draws=StepDraws(drop_keeps=[torch.tensor(k) for k in keeps], **mix_draws))
    assert calls[0] == len(keeps)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
