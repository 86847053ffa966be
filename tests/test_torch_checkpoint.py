"""The port's checkpoints: the protocol of tests/test_train.py on the port's
format (``torch.save`` of a train step's state under the reference torch
names, the same ``<name>.metadata.json`` sidecar as the JAX package).

A round trip is bitwise: parameters, BN statistics, optimizer state and EMA,
and a step taken after restoring equals the step the saved run takes next.
"""

import json
import os
import tarfile

import numpy as np
import pytest
import torch

from vit_search_torch.models import VisionTransformerSR
from vit_search_torch.train import (CheckpointManager, OptimConfig, StepDraws, TrainConfig,
                                    load_finetune, make_optimizer, make_train_step,
                                    restore_raw, unpack_checkpoint_archive)

from test_torch_model import NET

IMG, CLASSES, BATCH = 56, 10, 4


def _step(ema=True, seed=0):
    model = VisionTransformerSR(NET, img_size=IMG, patch_size=14, num_classes=CLASSES,
                                patch_output=True, drop_path_rate=0.1, device="cpu", seed=seed)
    opt = make_optimizer(OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=2), model)
    cfg = TrainConfig(num_classes=CLASSES, mixup_mode="token", patch_len=2,
                      ema_decay=0.9 if ema else None, erasing_prob=0.5)
    return make_train_step(model, opt, cfg, seed=seed, device="cpu")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, CLASSES, BATCH)))


def _fit(step, steps):
    for i in range(steps):
        step(*_batch(i))
    return step


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for part in ("params", "batch_stats", "ema_params"):
        assert sorted(sa[part]) == sorted(sb[part])
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    oa, ob = sa["optimizer"], sb["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])), (i, k)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    saved = _fit(_step(), 3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), snapshot_every=2)
    mgr.save_epoch(saved, epoch=1, metadata={"acc": 12.5}, is_best=True, is_best_ema=True)

    fresh = _fit(_step(seed=1), 1)
    meta = mgr.restore("checkpoint", fresh)
    assert meta == {"acc": 12.5, "epoch": 1}
    _assert_same_state(fresh, saved)

    # the next step from the restored state is the saved run's next step
    draws = StepDraws(drop_keeps=[torch.ones(BATCH, dtype=torch.bool)] * 12)
    # each step's draws come from (the run's seed, the restored step): the
    # seed is the caller's, as the JAX step's key is, not the checkpoint's
    fresh.seed = saved.seed
    images, labels = _batch(9)
    m_fresh, m_saved = fresh(images, labels, draws=draws), saved(images, labels, draws=draws)
    assert float(m_fresh["loss"]) == float(m_saved["loss"])
    _assert_same_state(fresh, saved)


def test_checkpoint_names_and_sidecar(tmp_path):
    step = _fit(_step(), 1)
    mgr = CheckpointManager(str(tmp_path), snapshot_every=2)
    assert mgr.latest() is None
    mgr.save_epoch(step, epoch=0, metadata={"acc": 1.0})
    assert mgr.exists("checkpoint") and not mgr.exists("epoch@0") and not mgr.exists("best")
    mgr.save_epoch(step, epoch=1, metadata={"acc": 2.0}, is_best=True, is_best_ema=True)
    for name in ("checkpoint", "epoch@1", "best", "best_ema"):
        assert mgr.exists(name), name
        with open(tmp_path / f"{name}.metadata.json") as f:
            assert json.load(f) == {"acc": 2.0, "epoch": 1}
    assert mgr.latest() == "checkpoint"
    assert sorted(os.listdir(tmp_path / "best")) == ["state.pt"]

    no_ema = _fit(_step(ema=False), 1)
    other = CheckpointManager(str(tmp_path / "no_ema"))
    other.save_epoch(no_ema, epoch=0, is_best_ema=True)
    assert not other.exists("best_ema")


def test_restore_raw_and_finetune_prefer_the_ema(tmp_path):
    step = _fit(_step(), 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("best_ema", step, {"acc": 3.0})
    raw = restore_raw(str(tmp_path / "best_ema"))
    assert set(raw) == {"step", "params", "batch_stats", "optimizer", "ema_params", "metadata"}
    assert raw["metadata"] == {"acc": 3.0} and raw["step"] == 2
    for k, v in step.state.ema_params.items():
        assert torch.equal(raw["ema_params"][k], v)

    # the finetune at 112 px takes the EMA, resized tables, its own BN statistics
    big = VisionTransformerSR(NET, img_size=112, patch_size=14, num_classes=CLASSES,
                              patch_output=True, device="cpu", seed=3)
    stats = {k: v.clone() for k, v in big.named_buffers()}
    assert load_finetune(big, str(tmp_path / "best_ema")) == {"acc": 3.0}
    ema = step.state.ema_params
    assert torch.equal(big.cls_head.weight, ema["cls_head.weight"])
    assert not torch.equal(big.cls_head.weight, step.model.cls_head.weight)
    assert big.pos_embed.shape == (1, 65, 32)
    assert torch.equal(big.pos_embed[:, :1], ema["pos_embed"][:, :1])
    assert all(torch.equal(v, stats[k]) for k, v in big.named_buffers())

    # without an EMA the finetune takes the parameters
    plain = _fit(_step(ema=False), 1)
    mgr.save("checkpoint", plain, {})
    assert restore_raw(str(tmp_path / "checkpoint"))["ema_params"] is None
    load_finetune(big, str(tmp_path / "checkpoint"))
    assert torch.equal(big.cls_head.weight, plain.model.cls_head.weight)


def test_restore_refuses_a_checkpoint_without_the_step_s_ema(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("checkpoint", _fit(_step(ema=False), 1), {})
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore("checkpoint", _step())


def test_unpack_checkpoint_archive_refuses_tar_slip_and_reads_xz(tmp_path):
    """tests/test_train.py's archive test on the port's checkpoint directory."""
    step = _fit(_step(), 1)
    CheckpointManager(str(tmp_path / "run")).save("checkpoint", step, {"acc": 4.0})
    src = tmp_path / "run" / "checkpoint"
    for ext, mode in (("tar.xz", "w:xz"), ("tar.bz2", "w:bz2")):
        arch = tmp_path / f"good.{ext}"
        with tarfile.open(arch, mode) as tf:
            tf.add(src, arcname="checkpoint")
        out = unpack_checkpoint_archive(str(arch))
        assert out.endswith("checkpoint") and os.path.isdir(out)
        assert restore_raw(out)["step"] == 1

    evil = tmp_path / "evil.tar"
    with tarfile.open(evil, "w") as tf:
        tf.add(src / "state.pt", arcname="../../escaped")
        tf.add(src, arcname="checkpoint")
    try:
        unpack_checkpoint_archive(str(evil))
    except tarfile.FilterError:
        pass  # refusing the whole archive is safe too
    assert not (tmp_path / "escaped").exists()
    assert not (tmp_path.parent / "escaped").exists()

    assert unpack_checkpoint_archive(str(src)) == str(src)
    empty = tmp_path / "empty.tar"
    with tarfile.open(empty, "w") as tf:
        tf.add(tmp_path / "good.tar.xz", arcname="not_a_checkpoint")
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        unpack_checkpoint_archive(str(empty))


def test_an_epochs_names_share_one_written_state(tmp_path):
    """``best``, ``best_ema`` and ``epoch@N`` of an epoch are ``checkpoint``'s
    file, written once; the next epoch's ``checkpoint`` replaces its own file
    and leaves them holding the earlier state."""
    step = _fit(_step(), 1)
    mgr = CheckpointManager(str(tmp_path), snapshot_every=1)
    mgr.save_epoch(step, epoch=0, metadata={"acc": 1.0}, is_best=True, is_best_ema=True)
    inode = os.stat(tmp_path / "checkpoint" / "state.pt").st_ino
    for name in ("epoch@0", "best", "best_ema"):
        assert os.stat(tmp_path / name / "state.pt").st_ino == inode, name
    before = restore_raw(str(tmp_path / "best"))
    _fit(step, 1)
    mgr.save_epoch(step, epoch=1, metadata={"acc": 0.5})
    assert os.stat(tmp_path / "checkpoint" / "state.pt").st_ino != inode
    assert os.stat(tmp_path / "best" / "state.pt").st_ino == inode
    after = restore_raw(str(tmp_path / "best"))
    assert after["step"] == before["step"] == 1 and after["metadata"]["epoch"] == 0
    assert restore_raw(str(tmp_path / "checkpoint"))["step"] == 2
    for k, v in before["params"].items():
        assert torch.equal(after["params"][k], v), k
