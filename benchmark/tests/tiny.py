"""A small supernet and its recipe, for the harness's tests on the CPU."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SPACE_NAME = "bench_tiny_test"
NETWORK_DEF = [[4, 32],
               [1, [32, 2, 16], [32, 64], 1], [1, [32, 2, 16], [32, 64], 1],
               [3, 32, 48],
               [1, [48, 2, 24], [48, 96], 1], [1, [48, 2, 24], [48, 96], 1],
               [3, 48, 64],
               [1, [64, 2, 32], [64, 128], 1], [1, [64, 2, 32], [64, 128], 1],
               [2, 64, 1000]]


def _block(attn, mlp, layer=None):
    return {"attn": attn, "mlp": mlp, "layer": layer}


SPACE = [[32, 24, 16],
         _block([32, 16], [64, 48, 32]), _block([32, 16], [64, 48, 32], [32, 32, 0, 0]),
         [48, 40, 32],
         _block([48, 24], [96, 64, 48]), _block([48, 24], [96, 64, 48], [48, 48, 0, 0]),
         [64, 56, 48],
         _block([64, 32], [128, 96, 64]), _block([64, 32], [128, 96, 64], [64, 64, 0, 0]),
         None]


def register_space():
    """Register :data:`SPACE` with the port under :data:`SPACE_NAME`."""
    import numpy as np
    from vit_search_torch.arch import spaces

    def space():
        return [None if s is None else
                {k: None if v is None else np.array(v) for k, v in s.items()}
                if isinstance(s, dict) else np.array(s) for s in SPACE]

    spaces.register_space(SPACE_NAME, space)


def load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def config():
    cfg = copy.deepcopy(load("configs", "vit_resnas_tiny_supernet.json"))
    cfg.update(network_def=NETWORK_DEF, space=SPACE, search_space=SPACE_NAME)
    return cfg


def mix(name="supernet_train"):
    m = copy.deepcopy(load("mixes", f"{name}.json"))
    m["flags"].update(batch_size=8, input_size=112, mixup_patch_len=2, example_per_arch=2)
    m["resident_batches"] = 4
    return m


def search_mix():
    """The search mix at the small net's size: its budget 0.99 of the net's
    multiply-adds (the conv stem's fixed 24 channels hold most of them)."""
    m = copy.deepcopy(load("mixes", "supernet_search.json"))
    m["flags"].update(input_size=112, val_bs=8, arch_batch=4, init_popu_size=12,
                      constraint_value=0.99 * 143_615_552)
    m.update(sub_val_images=20, profile_batches=2)
    return m
