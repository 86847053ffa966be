"""The port's meters, file logger and model hub (``vit_search_torch.utils``,
``vit_search_torch.hub``) against the JAX package's, on local files only:
no test needs the network (a download goes through ``file://`` or a
patched opener)."""

import logging
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu import hub as jax_hub
from vit_search_tpu.utils import MetricLogger as JaxMetricLogger
from vit_search_tpu.utils import SmoothedValue as JaxSmoothedValue
from vit_search_torch import hub
from vit_search_torch.models import available_models, create_model
from vit_search_torch.train import (CheckpointManager, OptimConfig, TrainConfig,
                                    make_optimizer, make_train_step)
from vit_search_torch.utils import MetricLogger, NoOpLogger, SmoothedValue, file_logger

from test_torch_model import NET

NAME = "flexible_vit_sr_patch14_224"
CLASSES = 4
SMALL_NET = NET[:-1] + ((2, 128, CLASSES),)


@pytest.mark.parametrize("window, values", [
    (3, (1, 2, 3, 4)), (1, (5.5, -2.0)), (20, tuple(np.linspace(0, 1, 25))), (4, ())])
def test_smoothed_value_matches_jax(window, values):
    ours, theirs = SmoothedValue(window_size=window), JaxSmoothedValue(window_size=window)
    for i, v in enumerate(values):
        ours.update(v, n=1 + i % 3)
        theirs.update(v, n=1 + i % 3)
    for attr in ("median", "avg", "global_avg", "max", "value", "count", "total"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert str(ours) == str(theirs)


def test_sync_defaults_to_one_process_and_takes_a_sum():
    v = SmoothedValue()
    v.update(2.0, n=2)
    logger = MetricLogger()
    logger.add_meter("x", v)
    logger.synchronize_between_processes()          # one process: unchanged
    assert (v.count, v.total) == (2, 4.0)
    logger.synchronize_between_processes(all_reduce=lambda arr: arr * 4)
    assert (v.count, v.total) == (8, 16.0) and v.global_avg == 2.0


def test_metric_logger_log_every_matches_jax(capsys):
    for cls in (MetricLogger, JaxMetricLogger):
        logger = cls()
        for batch in logger.log_every(range(5), print_freq=2, header="T:"):
            logger.update(loss=float(batch), acc=10.0 * batch)
        out = capsys.readouterr().out
        assert "T: [0/5]" in out and "T: [4/5]" in out and "Total time" in out
        assert logger.averages() == {"loss": 2.0, "acc": 20.0}
    assert str(logger).startswith("loss:")
    with pytest.raises(AttributeError):
        logger.missing


def test_file_logger_writes_three_files(tmp_path):
    log = file_logger(str(tmp_path), is_master=True)
    log.info("info line")
    log.warning("warn line")
    log.debug("debug line")
    for handler in logging.getLogger().handlers:
        handler.flush()
    verbose = (tmp_path / "verbose.log").read_text()
    event = (tmp_path / "event.log").read_text()
    debug = (tmp_path / "debug.log").read_text()
    assert "info line" in verbose and "warn line" in verbose
    assert "warn line" in event and "info line" not in event
    assert "debug line" in debug and "test_torch_utils.py" in debug
    quiet = file_logger(None, is_master=True)
    quiet.info("console only")
    assert isinstance(file_logger(str(tmp_path), is_master=False, is_rank0=False), NoOpLogger)


def _model(seed, **kwargs):
    return create_model(NAME, network_def=SMALL_NET, img_size=56, num_classes=CLASSES,
                        seed=seed, device="cpu", **kwargs)


def _logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.as_tensor(x))


def test_list_models_is_the_registry():
    assert hub.list_models() == available_models()
    assert set(hub.PRETRAINED_URLS) <= set(hub.list_models())


def test_reference_pth_loads_as_the_jax_hub_loads_it(tmp_path):
    """A reference state dict (DDP prefix, BN counters) loads into the
    port's names as it is; the JAX hub converts it; both nets agree."""
    sd = {f"module.{k}": v for k, v in _model(5).state_dict().items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in list(sd) if k.endswith("running_mean")})
    path = str(tmp_path / "ref.pth")
    torch.save({"model": sd, "epoch": 3}, path)

    ours = hub.load(NAME, checkpoint=path, network_def=SMALL_NET, img_size=56,
                    num_classes=CLASSES, device="cpu")
    jmodel, variables = jax_hub.load(NAME, checkpoint=path, network_def=SMALL_NET,
                                     img_size=56, num_classes=CLASSES)
    x = np.random.default_rng(0).normal(size=(2, 56, 56, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), deterministic=True))
    got = _logits(ours, x).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, _logits(_model(5), x).numpy())
    assert hub.load_torch_checkpoint(path)["epoch"] == 3


def test_load_a_port_checkpoint_prefers_the_ema(tmp_path):
    model = _model(0)
    step = make_train_step(model, make_optimizer(OptimConfig(), model),
                           TrainConfig(num_classes=CLASSES, ema_decay=0.5), device="cpu")
    step(torch.zeros(2, 56, 56, 3, dtype=torch.uint8), torch.tensor([0, 1]))
    CheckpointManager(str(tmp_path)).save("best_ema", step, {})
    loaded = hub.load(NAME, checkpoint=str(tmp_path / "best_ema"), network_def=SMALL_NET,
                      img_size=56, num_classes=CLASSES, device="cpu")
    for name, p in loaded.named_parameters():
        assert torch.equal(p, step.state.ema_params[name]), name
    for name, b in loaded.named_buffers():
        assert torch.equal(b, dict(model.named_buffers())[name]), name


def test_download_from_a_file_url_into_the_cache(tmp_path, monkeypatch):
    torch.save(_model(9).state_dict(), tmp_path / "bare.pth")
    monkeypatch.setenv("VST_HUB_CACHE", str(tmp_path / "cache"))
    url = (tmp_path / "bare.pth").as_uri()
    local = hub.download(url)
    assert local == str(tmp_path / "cache" / "bare.pth") and os.path.isfile(local)
    os.remove(tmp_path / "bare.pth")
    assert hub.download(url) == local            # cached: not fetched again
    x = np.random.default_rng(1).normal(size=(1, 56, 56, 3)).astype(np.float32)
    loaded = hub.load(NAME, checkpoint=url, network_def=SMALL_NET, img_size=56,
                      num_classes=CLASSES, device="cpu")
    np.testing.assert_array_equal(_logits(loaded, x).numpy(), _logits(_model(9), x).numpy())
    with pytest.raises(RuntimeError, match="could not download"):
        hub.download((tmp_path / "missing.pth").as_uri())


def test_pretrained_goes_through_the_published_url(tmp_path, monkeypatch):
    """``pretrained=True`` fetches the reference's published file; the
    opener is patched to a local copy, so nothing touches the network."""
    weights = create_model("deit_tiny_patch16_224", seed=4, device="cpu").state_dict()
    torch.save({"model": weights}, tmp_path / "published.pth")
    fetched = []

    def fake_retrieve(url, dest):
        fetched.append(url)
        os.link(tmp_path / "published.pth", dest)

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    monkeypatch.setenv("VST_HUB_CACHE", str(tmp_path / "cache"))
    model = hub.load("deit_tiny_patch16_224", pretrained=True, device="cpu")
    assert fetched == [hub.PRETRAINED_URLS["deit_tiny_patch16_224"]]
    for name, t in model.state_dict().items():
        assert torch.equal(t, weights[name]), name
    with pytest.raises(ValueError, match="no published pretrained weights"):
        hub.load(NAME, pretrained=True, network_def=SMALL_NET, img_size=56,
                 num_classes=CLASSES, device="cpu")
