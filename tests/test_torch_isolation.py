"""The port stands alone: it imports nothing of JAX or the JAX package, and
its entry points refuse to run without a CUDA device unless asked for the CPU."""

import ast
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vit_search_tpu")
TINY_NET = ((0, 16), (1, (16, 2, 8), (16, 32), 1), (2, 16, 4))


def _port_sources():
    return sorted((REPO / "vit_search_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_in_a_fresh_process():
    code = ("import sys, vit_search_torch, vit_search_torch.models, vit_search_torch.train, "
            "vit_search_torch.data, vit_search_torch.convert, vit_search_torch.ops.kernels, "
            "vit_search_torch.ops.stats, vit_search_torch.search, "
            "vit_search_torch.tools.attn_lab, vit_search_torch.models.surgery, "
            "vit_search_torch.data.erasing, vit_search_torch.train.checkpoint, "
            "vit_search_torch.train.state, vit_search_torch.models.regnet, "
            "vit_search_torch.ops.dropout, vit_search_torch.tools.teacher_check, "
            "vit_search_torch.data.loader, vit_search_torch.data.feed, "
            "vit_search_torch.data.datasets, vit_search_torch.data.transforms, "
            "vit_search_torch.data.samplers, vit_search_torch.data.subset, "
            "vit_search_torch.cli.train, vit_search_torch.hub, vit_search_torch.utils, "
            "vit_search_torch.tools.make_synthfolder, vit_search_torch.cli.evo_search, "
            "vit_search_torch.tools.loader_check, vit_search_torch.tools.accuracy_study, "
            "vit_search_torch.tools.render_results, vit_search_torch.tools.gelu_delta, "
            "vit_search_torch.tools.study_timing; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_needs_cuda_unless_cpu_is_asked(no_cuda):
    from vit_search_torch.models import create_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("flexible_vit_sr_patch14_224", network_def=TINY_NET, img_size=28)
    model = create_model("flexible_vit_sr_patch14_224", network_def=TINY_NET, img_size=28,
                         device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_train_step_needs_cuda_unless_cpu_is_asked(no_cuda):
    from vit_search_torch.models import create_model
    from vit_search_torch.train import OptimConfig, TrainConfig, make_optimizer, make_train_step

    model = create_model("flexible_vit_sr_patch14_224", network_def=TINY_NET, img_size=28,
                         device="cpu")
    opt = make_optimizer(OptimConfig(), model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, opt, TrainConfig(num_classes=4))
    step = make_train_step(model, opt, TrainConfig(num_classes=4), device="cpu")
    metrics = step(torch.zeros(2, 28, 28, 3, dtype=torch.uint8), torch.tensor([0, 1]))
    assert np.isfinite(float(metrics["loss"]))


def test_finetune_path_needs_cuda_unless_cpu_is_asked(no_cuda, tmp_path):
    """The searched-net step with erasing and EMA, a checkpoint, and the
    finetune of a 392 px net from it: each entry point refuses to start
    without a card unless the CPU is asked for."""
    from vit_search_torch.models import create_model
    from vit_search_torch.train import (CheckpointManager, OptimConfig, TrainConfig,
                                        load_finetune, make_eval_step, make_optimizer,
                                        make_train_step)

    net = ((4, 16), (1, (16, 2, 8), (16, 32), 1), (2, 16, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("flexible_vit_sr_patch14_392_patch_output", network_def=net,
                     num_classes=4)
    model = create_model("flexible_vit_sr_patch14_224_patch_output", network_def=net,
                         img_size=56, num_classes=4, device="cpu")
    cfg = TrainConfig(num_classes=4, mixup_mode="token", patch_len=4, ema_decay=0.9,
                      erasing_prob=0.25)
    opt = make_optimizer(OptimConfig(clip_grad=1.0), model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, opt, cfg)
    step = make_train_step(model, opt, cfg, device="cpu")
    step(torch.zeros(2, 56, 56, 3, dtype=torch.uint8), torch.tensor([0, 1]))
    CheckpointManager(str(tmp_path)).save("best_ema", step, {})
    big = create_model("flexible_vit_sr_patch14_392_patch_output", network_def=net,
                       num_classes=4, device="cpu")
    load_finetune(big, str(tmp_path / "best_ema"))
    assert big.pos_embed.shape == (1, 28 * 28 + 1, 16)
    metrics = make_eval_step(big, device="cpu")(torch.zeros(1, 392, 392, 3, dtype=torch.uint8),
                                                torch.tensor([0]))
    assert np.isfinite(float(metrics["loss_sum"]))


def test_eval_and_search_need_cuda_unless_cpu_is_asked(no_cuda):
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.search import BatchedSupernetEvaluator, make_tiled_correct_step
    from vit_search_torch.train import make_eval_step, make_per_example_correct_step

    model = create_model("flexible_vit_sr_patch14_224", network_def=TINY_NET, img_size=28,
                         device="cpu")
    space = [np.array([16, 8]), {"attn": np.array([16]), "mlp": np.array([32]),
                                 "layer": None}, None]
    sched = SupernetSchedules(TINY_NET, space, 1, 0)
    images, labels = torch.zeros(2, 28, 28, 3, dtype=torch.uint8), torch.tensor([0, 1])
    for make in (make_eval_step, make_per_example_correct_step, make_tiled_correct_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedSupernetEvaluator(model, sched, [(images, labels)])
    metrics = make_eval_step(model, device="cpu")(images, labels)
    assert float(metrics["count"]) == 2.0
    assert make_per_example_correct_step(model, device="cpu")(images, labels).shape == (2,)
    ev = BatchedSupernetEvaluator(model, sched, [(images, labels)], device="cpu")
    scores = ev.score([TINY_NET])
    assert len(scores) == 1 and 0.0 <= scores[0] <= 100.0


def test_kernel_wrappers_refuse_cpu_tensors():
    from vit_search_torch.ops import attention, stats
    from vit_search_torch.ops import masked_layer_norm as ln
    from vit_search_torch.tools import attn_lab

    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.attention_qkv_fwd_cuda(torch.zeros(1, 8, 48), 0.25, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ln.masked_ln_fwd_cuda(torch.zeros(1, 8, 16), torch.ones(1, 1, 16),
                              torch.ones(16), torch.zeros(16), 1e-6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stats.row_sum_sumsq_cuda(torch.zeros(1, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn_lab.fwd_T_cuda(torch.zeros(1, 8, 48), 0.25, 2)


def test_chip_smoke_refuses_without_cuda(no_cuda, capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# --- the plain EVA-02 reference and its benchmark copy -----------------------------

EVA_REFERENCES = (REPO / "tests" / "eva02_reference.py",
                  REPO / "benchmark" / "reference" / "eva02.py")


def test_eva02_reference_and_its_benchmark_copy_are_equal_statement_for_statement():
    ours, copy = ([ast.dump(node) for node in ast.parse(p.read_text()).body]
                  for p in EVA_REFERENCES)
    assert ours == copy


@pytest.mark.parametrize("path", EVA_REFERENCES, ids=lambda p: str(p.relative_to(REPO)))
def test_eva02_reference_imports_neither_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN + ("vit_search_torch",), name
