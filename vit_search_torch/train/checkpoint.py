"""Checkpoint save and restore of the port.

Port of vit_search_tpu/train/checkpoint.py, the reference checkpoint
protocol (main.py:401-424,501-523):

- a per-epoch ``checkpoint``, ``epoch@N`` snapshots every ``snapshot_every``
  epochs, ``best`` and ``best_ema`` on a new best accuracy; the epoch's
  other names hard-link ``checkpoint``'s file, so the state is written
  once (the JAX package writes each name in full);
- ``restore`` puts a checkpoint back into a train step;
- :func:`restore_raw` reads one without a target, for the finetune
  (:func:`load_finetune`, which prefers the EMA weights) and for supernet
  weight inheritance through ``models.surgery``.

Format: a checkpoint ``<dir>/<name>`` is a directory holding ``state.pt``,
``torch.save`` of a train step's ``state_dict()``: ``step``, ``params`` and
``batch_stats`` (state-dict entries under the reference torch names),
``optimizer`` (``torch.optim`` state dict) and ``ema_params`` (parameters
only, or ``None``). Run metadata (epoch, arguments, accuracies) is a
``<dir>/<name>.metadata.json`` sidecar, as in the JAX package. The JAX
package writes orbax checkpoints, a JAX library's format the port does not
read (it imports nothing of JAX); ``vit_search_torch.convert`` carries
weights between the two packages' trees.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..models.surgery import interpolate_pos_embeds

STATE_FILE = "state.pt"
ARCHIVE_SUFFIXES = (".zip", ".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tar.xz")


def _save_atomic(obj: Any, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read_metadata(path: str) -> Dict[str, Any]:
    meta_path = f"{path}.metadata.json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


class CheckpointManager:
    def __init__(self, directory: str, snapshot_every: int = 10):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.snapshot_every = snapshot_every

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, step, metadata: Dict[str, Any]) -> None:
        """Write ``step.state_dict()`` (a ``TrainStep``) and ``metadata``."""
        os.makedirs(self._path(name), exist_ok=True)
        _save_atomic(step.state_dict(), os.path.join(self._path(name), STATE_FILE))
        with open(f"{self._path(name)}.metadata.json", "w") as f:
            json.dump(metadata, f)

    def save_epoch(self, step, epoch: int, metadata: Optional[Dict[str, Any]] = None,
                   is_best: bool = False, is_best_ema: bool = False) -> None:
        """``checkpoint``, and the epoch's other names (``epoch@N``, ``best``,
        ``best_ema``) as the same state: its file hard-linked, written once
        (a later save of ``checkpoint`` replaces its file, not the links)."""
        meta = dict(metadata or {}, epoch=epoch)
        self.save("checkpoint", step, meta)
        names = []
        if self.snapshot_every and (epoch + 1) % self.snapshot_every == 0:
            names.append(f"epoch@{epoch}")
        if is_best:
            names.append("best")
        if is_best_ema and step.state.ema_params is not None:
            names.append("best_ema")
        for name in names:
            self._same_as("checkpoint", name, meta)

    def _same_as(self, src: str, name: str, metadata: Dict[str, Any]) -> None:
        """Checkpoint ``name`` holding ``src``'s state file: a hard link, or a
        copy where the file system has no links."""
        os.makedirs(self._path(name), exist_ok=True)
        source = os.path.join(self._path(src), STATE_FILE)
        target = os.path.join(self._path(name), STATE_FILE)
        tmp = f"{target}.tmp"
        if os.path.lexists(tmp):
            os.remove(tmp)
        try:
            os.link(source, tmp)
        except OSError:
            shutil.copyfile(source, tmp)
        os.replace(tmp, target)
        with open(f"{self._path(name)}.metadata.json", "w") as f:
            json.dump(metadata, f)

    def restore(self, name: str, step) -> Dict[str, Any]:
        """Load checkpoint ``name`` into ``step`` (a ``TrainStep``) in place;
        returns its metadata."""
        raw = restore_raw(self._path(name))
        step.load_state_dict(raw)
        return raw["metadata"]

    def exists(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self._path(name), STATE_FILE))

    def latest(self) -> Optional[str]:
        return "checkpoint" if self.exists("checkpoint") else None


def unpack_checkpoint_archive(path: str) -> str:
    """Extract a ``.zip`` / ``.tar[.gz|.bz2|.xz]`` of a checkpoint directory
    (a ``--resume`` URL carries a directory as an archive) and return the
    checkpoint directory inside, ``checkpoint`` first. Extraction happens
    once (an ``.ok`` marker beside the archive). Tar members that would land
    outside the extraction directory (``../``, absolute paths) are refused:
    archives are untrusted input. Any other path is returned as it is."""
    lower = path.lower()
    if not lower.endswith(ARCHIVE_SUFFIXES):
        return path
    dest = path + ".extracted"
    marker = dest + ".ok"
    if not os.path.exists(marker):
        if os.path.isdir(dest):
            shutil.rmtree(dest)
        if lower.endswith(".zip"):
            shutil.unpack_archive(path, dest)
        else:
            import tarfile

            with tarfile.open(path) as tf:
                tf.extractall(dest, filter="data")
        with open(marker, "w") as f:
            f.write("ok")
    found = []
    for root, dirs, files in os.walk(dest):
        if STATE_FILE in files:
            found.append(root)
            dirs.clear()
    if not found:
        raise FileNotFoundError(f"{path}: archive holds no checkpoint directory "
                                f"(no {STATE_FILE})")
    for root in sorted(found):
        if os.path.basename(root) == "checkpoint":
            return root
    return sorted(found)[0]


def restore_raw(path: str, map_location="cpu") -> Dict[str, Any]:
    """Read the checkpoint directory ``path`` without a target:
    ``{step, params, batch_stats, optimizer, ema_params, metadata}``, tensors
    on ``map_location``. Only tensors, numbers, strings and containers are
    unpickled (``weights_only``)."""
    path = os.path.abspath(path)
    out = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                     weights_only=True)
    out["metadata"] = _read_metadata(path)
    return out


def load_finetune(model: torch.nn.Module, path: str) -> Dict[str, Any]:
    """Start a finetune from checkpoint ``path`` (reference
    network_utils/finetune_state_dict.py:10-21, JAX cli/train.py:307-312):
    its EMA weights, or its parameters when it kept no EMA, with every
    position-embedding table resized to ``model``'s grids (on ``model``'s
    device), loaded into ``model``. As in the JAX package, the BN statistics
    stay ``model``'s own. Returns the checkpoint's metadata."""
    raw = restore_raw(path, map_location=next(model.parameters()).device)
    src = raw["ema_params"] if raw.get("ema_params") is not None else raw["params"]
    params = interpolate_pos_embeds(src, dict(model.named_parameters()), model.num_tokens)
    model.load_state_dict({**params, **dict(model.named_buffers())}, strict=True)
    return raw["metadata"]
