"""Numerics deviation of --gelu tanh vs exact on a trained checkpoint.

Port of vit_search_tpu/tools/gelu_delta.py on a port checkpoint (the
directory ``cli.train`` writes). Loads the checkpoint, runs the SAME val
batch through the forward pass with exact-erf GELU and with the tanh
approximation, and reports max/mean |delta logit| and top-1 prediction
agreement. The GELU form goes to the model as its ``gelu=`` argument; the
forward runs in bfloat16 on the card unless ``--device cpu`` asks for the
CPU.

Usage: python -m vit_search_torch.tools.gelu_delta \\
           CKPT_DIR DATA_DIR NETWORK_DEF_FILE [input_size] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

IMAGES = 256


def gelu_logits(ckpt_dir: str, data_dir: str, network_def: str, input_size: int = 112,
                device=None):
    """The same ``IMAGES`` val images (drawn by ``default_rng(0)``) through
    the checkpoint's net with each GELU form: ``(exact, tanh, labels,
    batch_shape)``, logits as float32 numpy arrays, ``batch_shape`` the NHWC
    shape of the normalized batch."""
    import torch

    from .. import arch, data, models, train
    from ..device import resolve_device

    device = resolve_device(device)
    net = arch.parse_network_def(network_def)
    raw = train.restore_raw(os.path.join(ckpt_dir, "checkpoints", "checkpoint"),
                            map_location=device)
    state = {**raw["params"], **(raw.get("batch_stats") or {})}

    ds = data.build_dataset(False, data_set="IMNET", data_path=data_dir,
                            transform=data.EvalTransform(size=input_size))
    rng = np.random.default_rng(0)
    idx = rng.choice(len(ds), size=IMAGES, replace=False)
    imgs, labels = [], []
    for i in idx:
        img, lbl = ds.load(int(i), rng)
        imgs.append(np.asarray(img))
        labels.append(lbl)
    x = np.stack(imgs).astype(np.float32) / 255.0
    mean = np.asarray(data.IMAGENET_MEAN, np.float32).reshape(1, 1, 1, -1)
    std = np.asarray(data.IMAGENET_STD, np.float32).reshape(1, 1, 1, -1)
    batch = torch.from_numpy((x - mean) / std).to(device)

    def fwd(flavor: str) -> np.ndarray:
        model = models.create_model(
            "flexible_vit_sr_patch14_224_patch_output", network_def=net,
            img_size=input_size, dtype=torch.bfloat16, gelu=flavor, device=device)
        model.load_state_dict(state, strict=True)
        model.eval()
        with torch.no_grad():
            return model(batch).float().cpu().numpy()

    return fwd("exact"), fwd("tanh"), np.asarray(labels), tuple(batch.shape)


def report(exact: np.ndarray, tanh: np.ndarray, labels: np.ndarray, batch_shape) -> dict:
    """Print the six lines of the JAX tool for the two logit arrays; return
    their numbers."""
    d = np.abs(exact - tanh)
    pe, pt = exact.argmax(-1), tanh.argmax(-1)
    out = {"max_abs_dlogit": float(d.max()), "mean_abs_dlogit": float(d.mean()),
           "logit_scale": float(np.abs(exact).mean()),
           "top1_agreement": float((pe == pt).mean() * 100), "top1_differ": int((pe != pt).sum()),
           "top1_acc_exact": float((pe == labels).mean() * 100),
           "top1_acc_tanh": float((pt == labels).mean() * 100)}
    print(f"batch: {tuple(batch_shape)}, logits: {exact.shape}")
    print(f"max |dlogit|  = {d.max():.6f}")
    print(f"mean |dlogit| = {d.mean():.6f}")
    print(f"logit scale (mean |exact|) = {np.abs(exact).mean():.4f}")
    print(f"top-1 agreement = {(pe == pt).mean() * 100:.2f}% "
          f"({(pe != pt).sum()}/{len(pe)} differ)")
    print(f"top-1 acc exact = {(pe == labels).mean() * 100:.2f}%  "
          f"tanh = {(pt == labels).mean() * 100:.2f}%")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir")
    p.add_argument("data_dir")
    p.add_argument("network_def_file")
    p.add_argument("input_size", nargs="?", type=int, default=112)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card) or 'cpu'; there is no fallback")
    args = p.parse_args(argv)
    with open(args.network_def_file) as f:
        network_def = f.read().strip()
    exact, tanh, labels, batch_shape = gelu_logits(args.ckpt_dir, args.data_dir, network_def,
                                                   args.input_size, args.device)
    return report(exact, tanh, labels, batch_shape)


if __name__ == "__main__":
    main()
