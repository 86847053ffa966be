"""The frozen cost model equals the port's estimator on both
configurations; the mfu arithmetic."""

import json
import os

import pytest

from conftest import BENCH


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,resolution,gmacs", [
    ("vit_resnas_tiny_supernet", 224, 3.4976), ("vit_resnas_medium", 224, 4.5131),
    ("vit_resnas_medium", 392, 14.9159)])
def test_frozen_macs_equal_the_estimator(name, resolution, gmacs):
    from benchlib import cost, shapes
    from vit_search_torch.arch.cost import ComputationEstimator

    net = shapes.to_tuple(config(name)["network_def"])
    macs = cost.macs(net, resolution)
    assert macs == ComputationEstimator(False, resolution, 14)(net)
    assert round(macs / 1e9, 4) == gmacs
    assert config(name)["macs_per_image"][str(resolution)] == macs


@pytest.mark.parametrize("rate", [1000.0, 4122.0])
def test_train_mfu(rate):
    from benchlib import harness

    reader = harness.load_module(os.path.join(BENCH, "metrics", "train.mfu.py"), "mfu")
    macs = 3_497_553_920
    assert reader.read({"imgs_per_s": rate, "macs_per_image": macs}) == pytest.approx(
        100.0 * rate * 6 * macs / 989e12)
    assert reader.read({"imgs_per_s": 0.0, "macs_per_image": macs}) is None
