"""Model hub entry points (reference ``hubconf.py``/``models.py`` parity).

Port of vit_search_tpu/hub.py:

- ``load(name, pretrained=True)`` downloads the reference's published
  ``.pth`` for that model into the hub cache (``VST_HUB_CACHE``, else
  ``~/.cache/vit_search_torch``; the URLs of reference models.py:22-53)
  and returns the model with those weights;
- ``load(name, checkpoint=...)`` accepts a port checkpoint directory (its
  EMA weights when it kept them), a local ``.pth(.tar)`` torch file, or an
  ``http(s)://`` / ``file://`` URL to either.

The port's parameters carry the reference's torch names, so a reference
state dict loads as it is: :func:`load_torch_checkpoint` only strips DDP's
``module.`` prefix and drops the BN ``num_batches_tracked`` counters, which
the port's flax-style batch norm does not keep.

Without network access a download raises a clear error; point
``checkpoint`` at a local file instead.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from .models import available_models, create_model
from .train.checkpoint import restore_raw

dependencies = ["torch"]  # torch.hub-style declaration

# reference models.py:22-53
PRETRAINED_URLS = {
    "deit_tiny_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_tiny_patch16_224-a1311bcf.pth",
    "deit_small_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_small_patch16_224-cd65a155.pth",
    "deit_base_patch16_224":
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_224-b5f2ef4d.pth",
}

TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt", ".bin")
URL_SCHEMES = ("http://", "https://", "file://")


def cache_dir() -> str:
    return os.environ.get(
        "VST_HUB_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "vit_search_torch"))


def download(url: str, dest_dir: Optional[str] = None) -> str:
    """Fetch ``url`` into the hub cache (idempotent); returns the path."""
    import urllib.parse
    import urllib.request

    dest_dir = dest_dir or cache_dir()
    os.makedirs(dest_dir, exist_ok=True)
    fname = os.path.basename(urllib.parse.urlparse(url).path) or "checkpoint"
    dest = os.path.join(dest_dir, fname)
    if os.path.exists(dest):
        return dest
    tmp = dest + ".tmp"
    try:
        urllib.request.urlretrieve(url, tmp)
    except OSError as e:
        raise RuntimeError(
            f"could not download {url} ({e}); without network access pass "
            f"checkpoint=<local path> instead") from e
    os.replace(tmp, dest)
    return dest


def _clean(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k.replace("module.", ""): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def load_torch_checkpoint(path: str) -> Dict:
    """Read a reference ``.pth(.tar)``: ``{"model": state dict, "model_ema":
    state dict (when saved), "epoch": int (training checkpoints)}``. A bare
    state dict is the ``model`` entry. Only tensors, containers and the
    checkpoint's ``argparse.Namespace`` are unpickled."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    out = {key: _clean(blob[key]) for key in ("model", "model_ema")
           if isinstance(blob, dict) and key in blob}
    if not out:
        out["model"] = _clean(blob)
    elif "epoch" in blob:
        # training checkpoints carry the epoch (reference main.py:409-411);
        # resume uses it to continue the LR schedule at epoch + 1
        out["epoch"] = int(blob["epoch"])
    return out


def load(name: str, checkpoint: Optional[str] = None, pretrained: bool = False,
         img_size: int = 224, seed: int = 0, device=None, **kwargs) -> torch.nn.Module:
    """Create a registered model (on the CUDA device unless ``device="cpu"``)
    and, optionally, load trained weights into it."""
    model = create_model(name, img_size=img_size, seed=seed, device=device, **kwargs)
    if pretrained and not checkpoint:
        if name not in PRETRAINED_URLS:
            raise ValueError(
                f"no published pretrained weights for {name!r}; available: "
                f"{sorted(PRETRAINED_URLS)}")
        checkpoint = PRETRAINED_URLS[name]
    if checkpoint and checkpoint.startswith(URL_SCHEMES):
        checkpoint = download(checkpoint)
    if checkpoint:
        if checkpoint.endswith(TORCH_SUFFIXES):
            model.load_state_dict(load_torch_checkpoint(checkpoint)["model"], strict=True)
        else:
            raw = restore_raw(checkpoint)
            params = raw["ema_params"] if raw.get("ema_params") is not None else raw["params"]
            model.load_state_dict({**raw["batch_stats"], **params}, strict=True)
    return model


def list_models():
    return available_models()
