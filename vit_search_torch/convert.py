"""Carry weights between the JAX package's trees and the port's state dict.

:func:`from_jax` turns the JAX model's ``params`` and ``batch_stats`` (nested
dicts of numpy arrays) into the port's state dict, whose keys are the
reference torch keys; :func:`to_jax` goes back. ``to_jax`` computes what
``vit_search_tpu.tools.convert_torch.convert_state_dict`` computes, and
``from_jax`` is its inverse. Layouts:

- Dense kernel ``(in, out)`` <-> linear weight ``(out, in)``;
- conv kernel ``(kh, kw, I, O)`` <-> conv weight ``(O, I, kh, kw)``;
- linear-stem kernel ``(p*p*I, O)`` <-> conv weight ``(O, I, p, p)``;
- BatchNorm ``scale``/``bias`` and ``mean``/``var`` <-> ``weight``/``bias``
  and ``running_mean``/``running_var``;
- ``blocks_<slot>`` <-> ``blocks.<slot - 1>`` (bypass slots keep their index).

An EMA tree is a ``params`` tree: ``from_jax(ema_params, None, net)`` gives
the port's EMA dict (parameters only, no BN statistics), and ``to_jax`` of
such a dict gives ``(ema_params, {})``. The same functions carry every
registered resolution and every ViT name (the flat ViTs and DeiT nets are
linear-stem network_defs with no SR block): the tables' lengths follow the
arrays.

The RegNetY teacher has its own pair, :func:`regnet_from_jax` and
:func:`regnet_to_jax`, between the JAX ``RegNetYUpsample``'s trees
(``{"regnet": ...}`` params and BN statistics: ``s<i>_b<j>`` blocks of
convs ``a``, ``b`` (grouped; HWIO kernels ``(3, 3, I / groups, O)``),
``c``, ``proj`` and the squeeze-excite's 1x1 convs ``se.fc1``/``se.fc2``
with bias, a Dense ``head``) and timm's ``regnety_160`` names
(``s<i+1>.b<j+1>.conv1/conv2/conv3/downsample``, ``head.fc``);
:func:`load_jax` picks the pair by the model.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .arch import network_def as nd

IN_CHANS = 3


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _to_linear(sd: Dict, name: str, leaf: Mapping) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_np(leaf["kernel"]).T)
    if "bias" in leaf:
        sd[f"{name}.bias"] = _np(leaf["bias"])


def _to_norm(sd: Dict, name: str, leaf: Mapping) -> None:
    sd[f"{name}.weight"] = _np(leaf["scale"])
    sd[f"{name}.bias"] = _np(leaf["bias"])


def _to_conv(sd: Dict, name: str, leaf: Mapping) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_np(leaf["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in leaf:
        sd[f"{name}.bias"] = _np(leaf["bias"])


def from_jax(params: Mapping, batch_stats: Optional[Mapping],
             network_def) -> Dict[str, np.ndarray]:
    """JAX ``(params, batch_stats)`` -> the port's state dict (numpy values);
    with ``batch_stats=None`` (an EMA tree), the parameters alone."""
    sd: Dict[str, np.ndarray] = {}
    pe = params["patch_embed"]
    if nd.block_type(network_def[0]) == nd.LINEAR_EMBED:
        kernel = _np(pe["proj"]["kernel"])
        p = int(round((kernel.shape[0] / IN_CHANS) ** 0.5))
        w = kernel.reshape(p, p, IN_CHANS, kernel.shape[1]).transpose(3, 2, 0, 1)
        sd["patch_embed.proj.weight"] = np.ascontiguousarray(w)
        sd["patch_embed.proj.bias"] = _np(pe["proj"]["bias"])
    else:
        _to_conv(sd, "patch_embed.conv_proj", pe["proj"])
        for c in ("conv1", "conv2", "conv3"):
            _to_conv(sd, f"patch_embed.{c}.conv", pe[c]["conv"])
            _to_norm(sd, f"patch_embed.{c}.bn", pe[c]["bn"])
            if batch_stats is None:
                continue
            stats = batch_stats["patch_embed"][c]["bn"]
            sd[f"patch_embed.{c}.bn.running_mean"] = _np(stats["mean"])
            sd[f"patch_embed.{c}.bn.running_var"] = _np(stats["var"])

    sd["tokens"] = _np(params["tokens"])
    sd["pos_embed"] = _np(params["pos_embed"])
    _to_norm(sd, "norm", params["norm"])
    for head in ("cls_head", "dst_head", "patch_head"):
        if head in params:
            _to_linear(sd, head, params[head])

    for slot, block in enumerate(network_def[1:-1], start=1):
        prefix = f"blocks.{slot - 1}"
        if nd.block_type(block) == nd.TRANSFORMER:
            if not block[3]:
                continue
            blk = params[f"blocks_{slot}"]
            _to_norm(sd, f"{prefix}.norm1", blk["norm1"])
            _to_norm(sd, f"{prefix}.norm2", blk["norm2"])
            _to_linear(sd, f"{prefix}.attn.qkv", blk["attn"]["qkv"])
            _to_linear(sd, f"{prefix}.attn.proj", blk["attn"]["proj"])
            _to_linear(sd, f"{prefix}.mlp.fc1", blk["mlp"]["fc1"])
            _to_linear(sd, f"{prefix}.mlp.fc2", blk["mlp"]["fc2"])
        else:
            blk = params[f"blocks_{slot}"]
            _to_norm(sd, f"{prefix}.norm", blk["norm"])
            _to_conv(sd, f"{prefix}.patch_reduce", blk["reduce"])
            _to_linear(sd, f"{prefix}.token_transform", blk["token_transform"])
            sd[f"{prefix}.pos_embed"] = _np(blk["pos_embed"])
    return sd


def _linear(sd: Mapping, name: str) -> Dict:
    out = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _norm(sd: Mapping, name: str) -> Dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _conv(sd: Mapping, name: str) -> Dict:
    out = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].transpose(2, 3, 1, 0))}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def to_jax(state_dict: Mapping, network_def) -> Tuple[Dict, Dict]:
    """The port's state dict (tensors or arrays) -> JAX ``(params,
    batch_stats)``; a dict without BN statistics (an EMA dict) gives empty
    ``batch_stats``."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params: Dict = {}
    batch_stats: Dict = {}
    if nd.block_type(network_def[0]) == nd.LINEAR_EMBED:
        w = sd["patch_embed.proj.weight"]          # (O, I, p, p)
        o, i, ph, pw = w.shape
        params["patch_embed"] = {"proj": {
            "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0).reshape(ph * pw * i, o)),
            "bias": sd["patch_embed.proj.bias"]}}
    else:
        pe: Dict = {"proj": _conv(sd, "patch_embed.conv_proj")}
        pe_stats: Dict = {}
        for c in ("conv1", "conv2", "conv3"):
            name = f"patch_embed.{c}.bn"
            pe[c] = {"conv": _conv(sd, f"patch_embed.{c}.conv"), "bn": _norm(sd, name)}
            if f"{name}.running_mean" in sd:
                pe_stats[c] = {"bn": {"mean": sd[f"{name}.running_mean"],
                                      "var": sd[f"{name}.running_var"]}}
        params["patch_embed"] = pe
        if pe_stats:
            batch_stats["patch_embed"] = pe_stats

    params["tokens"] = sd["tokens"]
    params["pos_embed"] = sd["pos_embed"]
    params["norm"] = _norm(sd, "norm")
    for head in ("cls_head", "dst_head", "patch_head"):
        if f"{head}.weight" in sd:
            params[head] = _linear(sd, head)

    for slot, block in enumerate(network_def[1:-1], start=1):
        prefix = f"blocks.{slot - 1}"
        if nd.block_type(block) == nd.TRANSFORMER:
            if block[3]:
                params[f"blocks_{slot}"] = {
                    "norm1": _norm(sd, f"{prefix}.norm1"),
                    "norm2": _norm(sd, f"{prefix}.norm2"),
                    "attn": {"qkv": _linear(sd, f"{prefix}.attn.qkv"),
                             "proj": _linear(sd, f"{prefix}.attn.proj")},
                    "mlp": {"fc1": _linear(sd, f"{prefix}.mlp.fc1"),
                            "fc2": _linear(sd, f"{prefix}.mlp.fc2")},
                }
        else:
            params[f"blocks_{slot}"] = {
                "norm": _norm(sd, f"{prefix}.norm"),
                "reduce": _conv(sd, f"{prefix}.patch_reduce"),
                "token_transform": _linear(sd, f"{prefix}.token_transform"),
                "pos_embed": sd[f"{prefix}.pos_embed"],
            }
    return params, batch_stats


# --- the RegNetY teacher ------------------------------------------------------

_REGNET_CONVS = (("a", "conv1"), ("b", "conv2"), ("c", "conv3"), ("proj", "downsample"))
_REGNET_BLOCK = re.compile(r"s(\d+)\.b(\d+)\.")


def _regnet_block_names(tree: Mapping):
    """``(jax name, port prefix)`` of every block of a JAX regnet tree, in order."""
    names = []
    for key in tree:
        m = re.fullmatch(r"s(\d+)_b(\d+)", key)
        if m:
            si, bi = int(m.group(1)), int(m.group(2))
            names.append(((si, bi), key, f"s{si + 1}.b{bi + 1}"))
    return [(key, prefix) for _, key, prefix in sorted(names)]


def regnet_from_jax(params: Mapping, batch_stats: Optional[Mapping]) -> Dict[str, np.ndarray]:
    """The JAX ``RegNetYUpsample``'s ``params`` and ``batch_stats`` (each
    ``{"regnet": ...}``) -> the port's teacher state dict (numpy values)."""
    p = params["regnet"]
    stats = None if batch_stats is None else batch_stats["regnet"]
    sd: Dict[str, np.ndarray] = {}

    def conv_bn(leaf: Mapping, leaf_stats: Optional[Mapping], name: str) -> None:
        _to_conv(sd, f"{name}.conv", leaf["conv"])
        _to_norm(sd, f"{name}.bn", leaf["bn"])
        if leaf_stats is not None:
            sd[f"{name}.bn.running_mean"] = _np(leaf_stats["bn"]["mean"])
            sd[f"{name}.bn.running_var"] = _np(leaf_stats["bn"]["var"])

    conv_bn(p["stem"], None if stats is None else stats["stem"], "stem")
    for key, prefix in _regnet_block_names(p):
        blk = p[key]
        for jname, tname in _REGNET_CONVS:
            if jname in blk:
                conv_bn(blk[jname], None if stats is None else stats[key][jname],
                        f"{prefix}.{tname}")
        _to_conv(sd, f"{prefix}.se.fc1", blk["se"]["fc1"])
        _to_conv(sd, f"{prefix}.se.fc2", blk["se"]["fc2"])
    _to_linear(sd, "head.fc", p["head"])
    return sd


def regnet_to_jax(state_dict: Mapping) -> Tuple[Dict, Dict]:
    """The port's teacher state dict -> JAX ``(params, batch_stats)``, each
    ``{"regnet": ...}``; a dict without BN statistics gives empty ones."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params: Dict = {}
    stats: Dict = {}

    def conv_bn(name: str):
        leaf = {"conv": _conv(sd, f"{name}.conv"), "bn": _norm(sd, f"{name}.bn")}
        if f"{name}.bn.running_mean" not in sd:
            return leaf, None
        return leaf, {"bn": {"mean": sd[f"{name}.bn.running_mean"],
                             "var": sd[f"{name}.bn.running_var"]}}

    params["stem"], stem_stats = conv_bn("stem")
    if stem_stats is not None:
        stats["stem"] = stem_stats
    blocks = sorted({(int(m.group(1)), int(m.group(2)))
                     for m in map(_REGNET_BLOCK.match, sd) if m})
    for si, bi in blocks:
        prefix, key = f"s{si}.b{bi}", f"s{si - 1}_b{bi - 1}"
        blk: Dict = {"se": {"fc1": _conv(sd, f"{prefix}.se.fc1"),
                            "fc2": _conv(sd, f"{prefix}.se.fc2")}}
        blk_stats: Dict = {}
        for jname, tname in _REGNET_CONVS:
            if f"{prefix}.{tname}.conv.weight" in sd:
                blk[jname], leaf_stats = conv_bn(f"{prefix}.{tname}")
                if leaf_stats is not None:
                    blk_stats[jname] = leaf_stats
        params[key] = blk
        if blk_stats:
            stats[key] = blk_stats
    params["head"] = _linear(sd, "head.fc")
    return {"regnet": params}, ({"regnet": stats} if stats else {})


def load_jax(model, params: Mapping, batch_stats: Mapping) -> None:
    """Load JAX trees into a port model (a ViT or the RegNetY teacher), in
    place (every key must match)."""
    from .models.regnet import RegNetY

    if isinstance(model, RegNetY):
        sd = regnet_from_jax(params, batch_stats)
    else:
        sd = from_jax(params, batch_stats, model.network_def)
    model.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
                          strict=True)
