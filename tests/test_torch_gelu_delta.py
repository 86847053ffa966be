"""The port's ``gelu_delta`` against the JAX package's tool, same weights.

A small net (``tests/test_torch_model.py``'s 56 px three-stage conv-stem
net, 10 classes) is initialised by the JAX package, written as a port
checkpoint through ``vit_search_torch.convert.from_jax``, and both tools
read the val split of one ``make_synthfolder`` folder (260 images at 64
px). The JAX tool runs with its ``train.restore_raw`` patched to return the
JAX tree (its Pallas attention in interpret mode, as on the CPU); the port
runs on the CPU (each kernel's plain version). The port's exact and tanh
logits must each be within ``chip_smoke.REF_NET_BF16_TOL["logits"]`` of the
JAX tool's (``|port - jax| <= 3e-2 * max|jax| + 3e-2 * |jax|``: both run the
net in bfloat16), and the port's report, fed the JAX logits, must print the
JAX tool's six lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_torch.convert import from_jax
from vit_search_torch.models import create_model
from vit_search_torch.tools import gelu_delta
from vit_search_torch.tools.make_synthfolder import generate
from vit_search_tpu import models as jax_models
from vit_search_tpu import train as jax_train
from vit_search_tpu.tools import gelu_delta as jax_gelu_delta

from chip_smoke import REF_NET_BF16_TOL
from test_torch_model import NET

IMG = 56
MODEL = "flexible_vit_sr_patch14_224_patch_output"


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """A val folder, the JAX tree, and the same weights as a port checkpoint."""
    root = tmp_path_factory.mktemp("gelu_delta")
    data = root / "data"
    generate(str(data), num_classes=10, train_per_class=0, val_per_class=26, size=64)
    (root / "net.txt").write_text(repr(NET))

    jmodel = jax_models.create_model(MODEL, network_def=NET, img_size=IMG)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    state = {k: torch.from_numpy(np.array(v))
             for k, v in from_jax(params, stats, NET).items()}
    names = {n for n, _ in create_model(MODEL, network_def=NET, img_size=IMG,
                                        device="cpu").named_parameters()}
    ckpt = root / "run" / "checkpoints" / "checkpoint"
    ckpt.mkdir(parents=True)
    torch.save({"step": 0, "params": {k: v for k, v in state.items() if k in names},
                "batch_stats": {k: v for k, v in state.items() if k not in names},
                "optimizer": {}, "ema_params": None}, ckpt / "state.pt")
    return {"root": root, "data": data, "params": params, "stats": stats}


def run_jax_tool(study, monkeypatch, capsys):
    """The JAX tool's six lines and its two logit arrays."""
    raw = {"params": study["params"], "batch_stats": study["stats"]}
    monkeypatch.setattr(jax_train, "restore_raw", lambda path: raw)
    logits = []
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):   # record each forward's logits as the tool computes them
        compiled = real_jit(fn, *args, **kwargs)

        def call(*a):
            out = compiled(*a)
            logits.append(np.asarray(out, np.float32))
            return out
        return call

    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr("sys.argv", ["gelu_delta", str(study["root"] / "run"),
                                     str(study["data"]), str(study["root"] / "net.txt"),
                                     str(IMG)])
    capsys.readouterr()
    jax_gelu_delta.main()
    monkeypatch.undo()
    lines = capsys.readouterr().out.splitlines()
    assert len(logits) == 2, len(logits)
    return lines, logits


def test_port_gelu_delta_equals_the_jax_tool(study, monkeypatch, capsys):
    jax_lines, (jax_exact, jax_tanh) = run_jax_tool(study, monkeypatch, capsys)
    assert len(jax_lines) == 6

    exact, tanh, labels, batch_shape = gelu_delta.gelu_logits(
        str(study["root"] / "run"), str(study["data"]), repr(NET), IMG, device="cpu")
    assert batch_shape == (gelu_delta.IMAGES, IMG, IMG, 3)
    atol, rtol = REF_NET_BF16_TOL["logits"]
    for got, want in ((exact, jax_exact), (tanh, jax_tanh)):
        assert got.shape == want.shape == (gelu_delta.IMAGES, 10)
        bound = atol * np.abs(want).max() + rtol * np.abs(want)
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    assert np.abs(exact - tanh).max() > 0   # the two forms differ

    capsys.readouterr()
    numbers = gelu_delta.report(jax_exact, jax_tanh, labels, batch_shape)
    assert capsys.readouterr().out.splitlines() == jax_lines
    assert all(np.isfinite(v) for v in numbers.values())


def test_port_gelu_delta_main_prints_its_report(study, capsys):
    """The CLI entry point on the CPU, and no card without ``--device cpu``."""
    args = [str(study["root"] / "run"), str(study["data"]), str(study["root"] / "net.txt"),
            str(IMG)]
    capsys.readouterr()
    numbers = gelu_delta.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and lines[0].startswith(f"batch: (256, {IMG}, {IMG}, 3)")
    assert 0.0 <= numbers["top1_agreement"] <= 100.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gelu_delta.main(args)
