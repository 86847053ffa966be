"""The port's training CLI (``vit_search_torch.cli.train``) end to end on
the CPU, on ``make_synthfolder`` data, with ``tests/test_cli_e2e.py`` as the
pattern: supernet training, eval-only, resume, inherited supernet weights,
KD with a teacher rebuilt from its checkpoint's arguments, a finetune at a
higher resolution, ``--drop-block`` rejected, ``--model-ema-force-cpu``, a
resume from a local reference ``.pth``, the sync-window invariance and a
mid-epoch preemption resume equal to an uninterrupted run, bit for bit.

The net is the 56 px three-stage conv-stem net of ``tests/test_torch_model``
with a 4-class head; its search space is registered in both packages'
registries (the port's spaces must stay a subset of the JAX package's,
``tests/test_torch_masking.py``).
"""

import json
import os
import re
import shlex
import signal
import threading
import time

import numpy as np
import pytest
import torch

from vit_search_tpu.arch import spaces as jax_spaces
from vit_search_tpu.cli.evo_search import get_args_parser as jax_evo_parser
from vit_search_tpu.cli.train import get_args_parser as jax_parser
from vit_search_torch.arch import spaces
from vit_search_torch.cli import evo_search as evo_cli
from vit_search_torch.cli import train as train_cli
from vit_search_torch.cli.train import get_args_parser
from vit_search_torch.data import build_subsets
from vit_search_torch.tools.make_synthfolder import generate
from vit_search_torch.train import restore_raw

from test_torch_model import NET, SPACE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 4
SUPER_NET = NET[:-1] + ((2, 128, CLASSES),)
SUB_NET = ((4, 24),
           (1, (24, 1, 16), (24, 48), 1),
           (1, (24, 1, 16), (24, 48), 0),
           (3, 24, 48),
           (1, (48, 2, 16), (48, 96), 1),
           (3, 48, 96),
           (1, (96, 2, 32), (96, 192), 1),
           (2, 96, CLASSES))
SPACE_NAME = "torch_cli_56"
for _registry in (spaces, jax_spaces):
    _registry.register_space(SPACE_NAME, lambda: SPACE)
SUPERNET = ["--model", "flexible_vit_sr_patch14_224_patch_output_supernet",
            "--network-def", repr(SUPER_NET), "--search-space", SPACE_NAME,
            "--example-per-arch", "4", "--num-warmup-epochs", "1",
            "--use-patch-mixup", "--mixup-patch-len", "1"]
DENSE = ["--model", "flexible_vit_sr_patch14_224", "--network-def", repr(SUPER_NET)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthfolder"))
    generate(root, num_classes=CLASSES, train_per_class=8, val_per_class=3, size=64, seed=0)
    build_subsets(root, per_class=2, seed=0)    # the search's sub-val
    return root


def _args(folder, extra):
    base = ["--data-path", folder, "--input-size", "56", "--batch-size", "8",
            "--val-bs", "8", "--epochs", "2", "--max-steps-per-epoch", "2",
            "--num_workers", "2", "--no-repeated-aug", "--no-bf16", "--warmup-epochs", "0",
            "--lr", "2e-3", "--reprob", "0.25", "--device", "cpu", "--print-freq", "2",
            "--seed", "0", "--drop-path", "0.1"]
    return get_args_parser().parse_args(base + extra)


def _params(out, name="checkpoint"):
    return restore_raw(os.path.join(out, "checkpoints", name))


@pytest.fixture(scope="module")
def supernet_run(folder, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("supernet"))
    result = train_cli.main(_args(folder, SUPERNET + ["--no-model-ema", "--output_dir", out]))
    return out, result


# --- flag parity -----------------------------------------------------------------

def _script_args(path):
    with open(path) as f:
        words = shlex.split(re.sub(r"\\\n", " ", f.read()), comments=True)
    module = next(w for w in words if w.startswith("vit_search_tpu.cli."))
    return module, words[words.index(module) + 1:]


SCRIPTS = sorted(os.path.relpath(os.path.join(d, f), REPO)
                 for d, _, fs in os.walk(os.path.join(REPO, "scripts", "vit-sr-nas"))
                 for f in fs if f.endswith(".sh"))


def test_the_24_scripts_are_all_found():
    assert len(SCRIPTS) == 24


@pytest.mark.parametrize("script", [s for s in SCRIPTS
                                    if _script_args(os.path.join(REPO, s))[0].endswith(".train")])
def test_training_script_parses_under_the_port_parser(script):
    """The script's arguments, from the one after ``-m vit_search_tpu.cli.train``
    on, parse unchanged under the port's parser, to the JAX parser's values
    (``--device`` aside: the port's default is the card)."""
    _, argv = _script_args(os.path.join(REPO, script))
    argv = [os.path.expandvars(w) for w in argv]
    ours = vars(get_args_parser().parse_args(argv))
    theirs = vars(jax_parser().parse_args(argv))
    assert ours.pop("device") == "cuda" and theirs.pop("device") == "tpu"
    assert ours == theirs


@pytest.mark.parametrize("script", [
    s for s in SCRIPTS if _script_args(os.path.join(REPO, s))[0].endswith(".evo_search")])
def test_search_script_parses_under_the_port_parser(script):
    """The same for ``-m vit_search_tpu.cli.evo_search`` and the port's
    search CLI (which adds ``--device``, the card by default)."""
    _, argv = _script_args(os.path.join(REPO, script))
    argv = [os.path.expandvars(w) for w in argv]
    ours = vars(evo_cli.get_args_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_evo_parser().parse_args(argv))


def test_parser_has_every_jax_flag_with_its_default():
    ours = {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type)
            for a in get_args_parser()._actions}
    theirs = {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type)
              for a in jax_parser()._actions}
    assert len(get_args_parser()._actions) == len(jax_parser()._actions) == 78
    ours_device, theirs_device = ours.pop("device"), theirs.pop("device")
    assert ours_device[0] == theirs_device[0] and ours_device[1] == "cuda"
    assert ours == theirs


# --- end to end --------------------------------------------------------------------

def test_supernet_training_end_to_end(supernet_run):
    out, result = supernet_run
    assert np.isfinite(result["train_loss"]) and 0.0 <= result["test_acc1"] <= 100.0
    with open(os.path.join(out, "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["epoch"] for line in lines] == [0, 1]
    for name in ("checkpoint", "best"):
        assert os.path.isfile(os.path.join(out, "checkpoints", name, "state.pt"))
    assert not os.path.exists(os.path.join(out, "checkpoints", "best_ema"))
    for name in ("verbose.log", "event.log", "debug.log"):
        assert os.path.exists(os.path.join(out, name))
    raw = _params(out)
    assert raw["step"] == 4 and raw["metadata"]["epoch"] == 1
    assert raw["metadata"]["args"]["model"] == SUPERNET[1]


def test_eval_only_path(supernet_run, folder):
    out, _ = supernet_run
    result = train_cli.main(_args(folder, SUPERNET + ["--no-model-ema", "--output_dir", out,
                                                      "--resume", "auto", "--eval"]))
    assert 0.0 <= result["eval"]["acc1"] <= 100.0 and np.isfinite(result["eval"]["loss"])


def test_resume_continues(supernet_run, folder, tmp_path):
    import shutil

    out, _ = supernet_run
    copy = str(tmp_path / "copy")
    shutil.copytree(out, copy)
    result = train_cli.main(_args(folder, SUPERNET + ["--no-model-ema", "--output_dir", copy,
                                                      "--resume", "auto", "--epochs", "3"]))
    assert result["epoch"] == 2  # epochs 0 and 1 were done
    assert _params(copy)["step"] == 6


def test_resume_from_a_checkpoint_archive_url(supernet_run, folder, tmp_path, monkeypatch):
    """``--resume file://.../ckpt.tar.gz`` goes through the hub cache and
    restores the archived checkpoint with its epoch."""
    import shutil

    out, _ = supernet_run
    archive = shutil.make_archive(str(tmp_path / "ckpts"), "gztar",
                                  os.path.join(out, "checkpoints"))
    monkeypatch.setenv("VST_HUB_CACHE", str(tmp_path / "cache"))
    result = train_cli.main(_args(folder, SUPERNET + [
        "--no-model-ema", "--output_dir", str(tmp_path / "resumed"),
        "--resume", "file://" + archive, "--epochs", "3"]))
    assert result["epoch"] == 2


def test_searched_net_training_with_inherited_weights(supernet_run, folder, tmp_path):
    out, _ = supernet_run
    result = train_cli.main(_args(folder, [
        "--model", "flexible_vit_sr_patch14_224", "--network-def", repr(SUB_NET),
        "--epochs", "1", "--no-model-ema", "--output_dir", str(tmp_path / "searched"),
        "--resume-supernet-weights", os.path.join(out, "checkpoints", "checkpoint")]))
    assert np.isfinite(result["train_loss"])
    # the subnet's weights are the supernet's, cut to the subnet's widths
    from vit_search_torch.models import create_model, slice_subnet_params

    sub = create_model("flexible_vit_sr_patch14_224", network_def=SUB_NET, img_size=56,
                       num_classes=CLASSES, device="cpu")
    supernet = _params(out)["params"]
    sliced = slice_subnet_params(supernet, dict(sub.named_parameters()))
    assert torch.equal(sliced["pos_embed"], supernet["pos_embed"][..., :24])


def test_kd_training_with_teacher_from_ckpt_args(folder, tmp_path):
    """The teacher is rebuilt from its checkpoint's own arguments (model,
    network_def, input size); ``--teacher-model`` names another model on
    purpose and must lose."""
    t_out = str(tmp_path / "teacher")
    train_cli.main(_args(folder, DENSE + ["--epochs", "1", "--no-model-ema",
                                          "--output_dir", t_out]))
    result = train_cli.main(_args(folder, [
        "--model", "flexible_vit_sr_distill_patch14_224", "--network-def", repr(SUB_NET),
        "--epochs", "1", "--no-model-ema", "--output_dir", str(tmp_path / "student"),
        "--teacher-ckpt-path", os.path.join(t_out, "checkpoints", "checkpoint"),
        "--teacher-model", "regnety_160_upsample", "--distill-alpha", "0.5"]))
    assert np.isfinite(result["train_loss"])
    assert 0.0 <= result["test_dst_top1"] <= 100.0


def test_build_teacher_prefers_the_checkpoint_args(folder, tmp_path):
    from vit_search_torch.utils import file_logger

    out = str(tmp_path / "t")
    train_cli.main(_args(folder, DENSE + ["--epochs", "1", "--no-model-ema",
                                          "--output_dir", out]))
    teacher = train_cli.build_teacher(os.path.join(out, "checkpoints", "checkpoint"),
                                      "regnety_160_upsample", CLASSES, torch.float32,
                                      file_logger(None, is_master=True), device="cpu")
    images = torch.zeros(2, 56, 56, 3)
    assert teacher(images).shape == (2, CLASSES)


def test_finetune_at_a_higher_resolution(folder, tmp_path):
    lo = str(tmp_path / "lo")
    train_cli.main(_args(folder, DENSE + ["--no-model-ema", "--output_dir", lo]))
    hi = str(tmp_path / "hi")
    result = train_cli.main(_args(folder, DENSE + [
        "--input-size", "112", "--epochs", "1", "--no-model-ema",
        "--finetune", os.path.join(lo, "checkpoints", "checkpoint"), "--output_dir", hi]))
    assert np.isfinite(result["train_loss"]) and "test_acc1" in result
    assert _params(hi)["params"]["pos_embed"].shape == (1, 8 * 8 + 1, 32)
    with open(os.path.join(hi, "verbose.log")) as f:
        assert sum(line.startswith("eval:") for line in f) == 2  # pre-finetune eval + epoch


def test_drop_block_rejected(folder):
    with pytest.raises(NotImplementedError, match="drop-block"):
        train_cli.main(_args(folder, DENSE + ["--drop-block", "0.1"]))


def test_no_card_and_no_cpu_request_fails_loudly(folder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(folder, DENSE)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(args)


def test_model_ema_force_cpu(folder, tmp_path):
    """--model-ema-force-cpu keeps the EMA in host memory: the same EMA as
    the device path, the same checkpoint layout; EMA eval and resume work."""
    outs = {}
    for tag, extra in (("device", []), ("host", ["--model-ema-force-cpu"])):
        outs[tag] = str(tmp_path / tag)
        result = train_cli.main(_args(folder, DENSE + [
            "--model-ema", "--model-ema-decay", "0.9", "--output_dir", outs[tag]] + extra))
        assert "ema_test_acc1" in result
    for name in ("checkpoint", "best_ema"):
        a, b = _params(outs["device"], name), _params(outs["host"], name)
        assert sorted(a["ema_params"]) == sorted(b["ema_params"])
        for k in a["ema_params"]:
            assert torch.equal(a["ema_params"][k], b["ema_params"][k]), k
    result = train_cli.main(_args(folder, DENSE + [
        "--model-ema", "--model-ema-decay", "0.9", "--model-ema-force-cpu",
        "--output_dir", outs["host"], "--resume", "auto", "--eval"]))
    assert "acc1" in result["eval"]
    resumed = train_cli.main(_args(folder, DENSE + [
        "--model-ema", "--model-ema-decay", "0.9", "--model-ema-force-cpu", "--epochs", "3",
        "--output_dir", outs["host"], "--resume", "auto"]))
    assert resumed["epoch"] == 2 and "ema_test_acc1" in resumed


def test_resume_from_a_local_reference_pth(folder, tmp_path):
    """A reference-format training checkpoint (``model``, ``model_ema``,
    ``epoch``, an argparse namespace): --eval scores ``model_ema``; a
    training resume restores the epoch and the EMA (Adam restarts)."""
    import argparse

    from vit_search_torch.models import create_model

    def weights(seed):
        model = create_model("flexible_vit_sr_patch14_224", network_def=SUPER_NET,
                             img_size=56, num_classes=CLASSES, seed=seed, device="cpu")
        sd = {f"module.{k}": v for k, v in model.state_dict().items()}
        sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(5)
                   for k in sd if k.endswith("running_mean")})
        return sd

    sd_a, sd_b = weights(11), weights(22)
    full, ema_as_model = tmp_path / "full.pth", tmp_path / "ema_as_model.pth"
    torch.save({"model": sd_a, "model_ema": sd_b, "epoch": 2,
                "args": argparse.Namespace(model="x")}, full)
    torch.save({"model": sd_b}, ema_as_model)

    stats_full = train_cli.main(_args(folder, DENSE + ["--no-model-ema", "--eval",
                                                       "--resume", str(full)]))["eval"]
    stats_b = train_cli.main(_args(folder, DENSE + ["--no-model-ema", "--eval",
                                                    "--resume", str(ema_as_model)]))["eval"]
    assert stats_full == stats_b

    out = str(tmp_path / "resumed")
    result = train_cli.main(_args(folder, DENSE + [
        "--model-ema", "--model-ema-decay", "0.9", "--output_dir", out,
        "--resume", str(full), "--epochs", "4"]))
    assert result["epoch"] == 3 and "ema_test_acc1" in result
    with open(os.path.join(out, "event.log")) as f:
        assert "optimizer state restarts fresh" in f.read()


def test_train_sync_window_invariance(folder, tmp_path, monkeypatch):
    """VST_TRAIN_SYNC_EVERY only changes WHEN metrics are fetched, never
    their values."""
    curves = {}
    for cadence in ("1", "4"):
        monkeypatch.setenv("VST_TRAIN_SYNC_EVERY", cadence)
        out = str(tmp_path / f"sync{cadence}")
        train_cli.main(_args(folder, DENSE + ["--no-model-ema", "--output_dir", out,
                                              "--max-steps-per-epoch", "3"]))
        with open(os.path.join(out, "log.txt")) as f:
            curves[cadence] = [json.loads(line)["train_loss"] for line in f]
    assert curves["1"] == curves["4"]


class _FireAfter:
    """A deterministic stand-in for the SIGTERM flag."""

    def __init__(self, n):
        self.left = n

    def is_set(self):
        self.left -= 1
        return self.left < 0

    def clear(self):
        pass


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_mid_epoch_preemption_resume_equivalence(folder, tmp_path, monkeypatch, backend):
    """A run preempted MID-epoch and resumed with --resume auto reproduces
    the uninterrupted run bit for bit: the preemption checkpoint holds the
    post-step state, the resume skips the applied steps (advancing the keep
    counts' host generator through them), and every step's draws (erasing,
    token mixup, drop-path) come from (seed, step). The supernet rewires its
    weights at the epoch boundaries of its warmup."""
    common = SUPERNET + ["--model-ema", "--model-ema-decay", "0.9", "--epochs", "3",
                         "--max-steps-per-epoch", "3", "--loader-backend", backend]

    out_a = str(tmp_path / "uninterrupted")
    train_cli.main(_args(folder, common + ["--output_dir", out_a]))

    # the 5th post-step check fires: epoch 1 (of 3), step 1 (of 3)
    out_b = str(tmp_path / "preempted")
    monkeypatch.setattr(train_cli, "_PREEMPTED", _FireAfter(4))
    result = train_cli.main(_args(folder, common + ["--output_dir", out_b]))
    assert result.get("preempted") and (result["epoch"], result["step"]) == (1, 1)
    meta = _params(out_b)["metadata"]
    assert (meta["preempted_step"], meta["steps_per_epoch"], meta["epoch"]) == (4, 3, 0)

    monkeypatch.setattr(train_cli, "_PREEMPTED", _FireAfter(10 ** 9))
    resumed = train_cli.main(_args(folder, common + ["--output_dir", out_b,
                                                     "--resume", "auto"]))
    assert resumed["epoch"] == 2

    a, b = _params(out_a), _params(out_b)
    assert a["step"] == b["step"] == 9
    for part in ("params", "batch_stats", "ema_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    with open(os.path.join(out_a, "log.txt")) as f:
        losses_a = [json.loads(line)["train_loss"] for line in f]
    with open(os.path.join(out_b, "log.txt")) as f:
        losses_b = [json.loads(line)["train_loss"] for line in f]
    assert losses_a[0] == losses_b[0] and losses_a[2] == losses_b[-1]


def test_mid_epoch_resume_steps_mismatch_falls_back(folder, tmp_path, monkeypatch):
    out = str(tmp_path / "mismatch")
    monkeypatch.setattr(train_cli, "_PREEMPTED", _FireAfter(3))
    result = train_cli.main(_args(folder, DENSE + ["--no-model-ema", "--epochs", "3",
                                                   "--output_dir", out]))
    assert result.get("preempted")
    monkeypatch.setattr(train_cli, "_PREEMPTED", _FireAfter(10 ** 9))
    resumed = train_cli.main(_args(folder, DENSE + [
        "--no-model-ema", "--epochs", "3", "--max-steps-per-epoch", "1",
        "--output_dir", out, "--resume", "auto"]))
    assert resumed["epoch"] == 2
    with open(os.path.join(out, "verbose.log")) as f:
        assert "re-running the interrupted epoch from its start" in f.read()


def test_sigterm_checkpoints_and_exits(folder, tmp_path, monkeypatch):
    """SIGTERM mid-training sets the preemption flag; the epoch loop
    checkpoints with ``preempted_step`` and returns; the process backend's
    workers still end."""
    monkeypatch.setattr(train_cli, "_PREEMPTED", threading.Event())
    previous = signal.getsignal(signal.SIGTERM)
    out = str(tmp_path / "sigterm")
    log = os.path.join(out, "log.txt")

    def preempt():
        deadline = time.time() + 120
        while time.time() < deadline and not (os.path.exists(log) and open(log).read()):
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    killer = threading.Thread(target=preempt, daemon=True)
    killer.start()
    try:
        result = train_cli.main(_args(folder, DENSE + [
            "--no-model-ema", "--epochs", "50", "--loader-backend", "process",
            "--output_dir", out]))
        restored = signal.getsignal(signal.SIGTERM)
    finally:
        killer.join(timeout=5)
        signal.signal(signal.SIGTERM, previous)
    assert restored is previous   # the run's handler lasts as long as the run
    assert result.get("preempted") and result["epoch"] >= 1
    meta = _params(out)["metadata"]
    assert meta["epoch"] == result["epoch"] - 1 and "preempted_step" in meta


def test_evolutionary_search_end_to_end(supernet_run, folder, tmp_path):
    """``vit_search_torch.cli.evo_search`` on the trained supernet's
    checkpoint and the sub-val split: every candidate in the MAC band,
    scores in [0, 100], the JAX CLI's artifacts."""
    from vit_search_torch.arch import ComputationEstimator, network_def as nd

    out, _ = supernet_run
    est = ComputationEstimator(distill=False, input_resolution=56, patch_size=14)
    # the conv stem dominates at 56 px: the space spans 99.5-100% of the MACs
    constraint = est(SUPER_NET) * 0.998
    search_out = str(tmp_path / "search")
    args = evo_cli.get_args_parser().parse_args([
        "--data-path", folder, "--val-bs", "4", "--num_workers", "2", "--input-size", "56",
        "--model", "flexible_vit_sr_patch14_224_patch_output",
        "--model-path", os.path.join(out, "checkpoints", "checkpoint"),
        "--network-def", repr(SUPER_NET), "--search-space", SPACE_NAME,
        "--constraint-value", str(constraint), "--search-iter", "2", "--init-popu-size", "6",
        "--parent-size", "4", "--mutate-size", "3", "--arch-batch", "4", "--no-bf16",
        "--max-eval-batches", "2", "--output_dir", search_out, "--device", "cpu"])
    result = evo_cli.main(args)
    nd.validate(result["best_network_def"])
    assert est(result["best_network_def"]) <= constraint
    assert 0.0 <= result["best_score"] <= 100.0 and len(result["best_per_iter"]) == 2
    for name in ("iter@0_popu.pickle", "iter@1_popu.txt", "summary.txt", "history.csv"):
        assert os.path.exists(os.path.join(search_out, name)), name


@pytest.mark.parametrize("trained_ema, resumed_ema", [(True, False), (False, True)],
                         ids=["eval-without-ema", "resume-with-ema"])
def test_checkpoint_and_run_disagree_on_the_ema(folder, tmp_path, trained_ema, resumed_ema):
    """The eval scripts pass --no-model-ema on checkpoints trained with an
    EMA: the EMA is not restored and the parameters are scored. A run that
    keeps an EMA resumed from a checkpoint without one starts its EMA from
    the restored parameters."""
    out = str(tmp_path / "run")

    def ema(on):
        return ["--model-ema", "--model-ema-decay", "0.9"] if on else ["--no-model-ema"]

    train_cli.main(_args(folder, DENSE + ema(trained_ema) + ["--output_dir", out]))
    if trained_ema:
        result = train_cli.main(_args(folder, DENSE + ema(False) + [
            "--output_dir", out, "--resume", "auto", "--eval"]))
        assert 0.0 <= result["eval"]["acc1"] <= 100.0
        with open(os.path.join(out, "verbose.log")) as f:
            assert "checkpoint EMA not restored" in f.read()
    else:
        result = train_cli.main(_args(folder, DENSE + ema(True) + [
            "--output_dir", out, "--resume", "auto", "--epochs", "3"]))
        assert result["epoch"] == 2 and "ema_test_acc1" in result
        with open(os.path.join(out, "event.log")) as f:
            assert "the EMA restarts from its parameters" in f.read()


def test_profile_dir_writes_a_trace(folder, tmp_path):
    trace_dir = tmp_path / "trace"
    train_cli.main(_args(folder, DENSE + ["--no-model-ema", "--epochs", "1",
                                          "--max-steps-per-epoch", "3", "--profile-dir",
                                          str(trace_dir), "--profile-steps", "2"]))
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "vst.train.step"]
    assert steps and all(e["cat"] == "cpu_op" for e in steps)
