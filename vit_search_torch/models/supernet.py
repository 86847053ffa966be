"""Supernet architecture sampling: keep-count trees and mask building.

Port of vit_search_tpu/models/supernet.py:

  host:   SupernetSchedules.sample(rng, batch)   ->  keep-count tree (numpy ints)
          (or .counts_for_subnets(defs): the tree that selects given candidates)
  device: build_arch_masks(counts, ...)          ->  mask tree (boolean masks,
                                                    per-example counts)
  device: model(x, masks=...)

The keep-count tree mirrors the network_def slots::

  {'embed': (A,) ints | None,
   'slots': {slot: {'attn': (A,), 'mlp': (A,), 'layer': (A,)|None}   # transformer
                   | {'embed': (A,)}                                  # SR block
            }}

``A`` is ``batch // example_per_arch`` for multi-arch sites or 1 for shared
sites; masks are expanded round-robin over the batch (example ``b`` gets
architecture ``b % A``). ``pack``/``unpack`` move the whole tree as one int32
vector, one host-to-device copy per step.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..arch import network_def as nd
from ..ops import prefix_mask
from ..ops.masking import ChannelDropSchedule, expand_arch_counts, make_channel_mask
from ..utils.trace import span

ARCH_MODES = ("single", "hybrid", "multi")


class SupernetSchedules:
    """Host-side keep-count sampler for every ChannelDrop site of a supernet."""

    def __init__(self, network_def: Sequence, space: Sequence,
                 example_per_arch: Optional[int], num_warmup_epochs: int = 15,
                 arch_mode: str = "multi"):
        if arch_mode not in ARCH_MODES:
            raise ValueError(f"arch_mode must be one of {ARCH_MODES}")
        if len(space) != len(network_def):
            raise ValueError("search space and network_def length mismatch")
        self.network_def = nd.to_immutable(network_def)
        self.space = space
        self.arch_mode = arch_mode
        self.example_per_arch = example_per_arch

        shared = arch_mode in ("single", "hybrid")      # embed/SR sites
        block_shared = arch_mode == "single"            # attn/mlp/layer sites

        def make(widths, single):
            return ChannelDropSchedule(widths, num_warmup_epochs=num_warmup_epochs,
                                       example_per_arch=example_per_arch,
                                       single_arch=single)

        self.embed: Optional[ChannelDropSchedule] = None
        self.slots: Dict[int, Dict[str, ChannelDropSchedule]] = {}
        for slot, (block, keep) in enumerate(zip(self.network_def, space)):
            btype = nd.block_type(block)
            if btype in nd.EMBED_TYPES:
                self.embed = make(keep, shared)
            elif btype == nd.SPATIAL_REDUCTION:
                self.slots[slot] = {"embed": make(keep, shared)}
            elif btype == nd.TRANSFORMER:
                site = {"attn": make(keep["attn"], block_shared),
                        "mlp": make(keep["mlp"], block_shared)}
                if keep.get("layer") is not None:
                    site["layer"] = make(keep["layer"], block_shared)
                self.slots[slot] = site

    def set_epoch(self, epoch: int) -> None:
        if self.embed is not None:
            self.embed.set_epoch(epoch)
        for site in self.slots.values():
            for sched in site.values():
                sched.set_epoch(epoch)

    def sample(self, rng: np.random.Generator, batch: int) -> Dict:
        """Per-step keep counts for every site (host, numpy)."""
        counts = {"embed": None if self.embed is None else self.embed.sample(rng, batch),
                  "slots": {}}
        for slot, site in self.slots.items():
            counts["slots"][slot] = {k: s.sample(rng, batch) for k, s in site.items()}
        return counts

    def full_counts(self) -> Dict:
        """Eval-mode counts: every channel kept (shape (1,), broadcast)."""
        counts = {"embed": None if self.embed is None else self.embed.full_counts(),
                  "slots": {}}
        for slot, site in self.slots.items():
            counts["slots"][slot] = {k: s.full_counts() for k, s in site.items()}
        return counts

    def _site_order(self):
        order = []
        if self.embed is not None:
            order.append((("embed",), self.embed))
        for slot in sorted(self.slots):
            for key in sorted(self.slots[slot]):
                order.append((("slots", slot, key), self.slots[slot][key]))
        return order

    def packed_layout(self, batch: int) -> tuple:
        """Static (path, count_len) layout for a given batch size."""
        return tuple((path, 1 if sched.single_arch else batch // sched.example_per_arch)
                     for path, sched in self._site_order())

    def pack(self, counts: Dict, batch: int) -> np.ndarray:
        parts = []
        for path, n in self.packed_layout(batch):
            node = counts
            for key in path:
                node = node[key]
            if len(node) != n:
                raise ValueError(f"site {path} has {len(node)} counts, expected {n}")
            parts.append(np.asarray(node, dtype=np.int32))
        return np.concatenate(parts)

    def sample_packed(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        with span("vst.supernet.sample"):
            return self.pack(self.sample(rng, batch), batch)

    def unpack(self, vector, batch: int) -> Dict:
        """Inverse of :meth:`pack` (works on numpy arrays and tensors)."""
        counts: Dict = {"embed": None, "slots": {}}
        offset = 0
        for path, n in self.packed_layout(batch):
            piece = vector[offset:offset + n]
            offset += n
            if path == ("embed",):
                counts["embed"] = piece
            else:
                _, slot, key = path
                counts["slots"].setdefault(slot, {})[key] = piece
        return counts

    def counts_for_subnets(self, sub_defs: Sequence[Sequence]) -> Dict:
        """Keep counts that select explicit candidate network_defs.

        Entry ``a`` of every returned ``(A,)`` array selects exactly
        ``sub_defs[a]``: masked evaluation in place of the reference's
        per-candidate weight extraction. A removed slot keeps the supernet's
        widths with layer count 0.
        """
        num = len(sub_defs)
        if any(len(sub) != len(self.network_def) for sub in sub_defs):
            raise ValueError("candidate def has different slot count")
        counts: Dict = {"embed": None, "slots": {}}
        if self.embed is not None:
            counts["embed"] = np.array([nd.embed_channels(sub[0]) for sub in sub_defs],
                                       dtype=np.int64)
        for slot, site in self.slots.items():
            sup_block = self.network_def[slot]
            if nd.block_type(sup_block) == nd.SPATIAL_REDUCTION:
                counts["slots"][slot] = {"embed": np.array(
                    [nd.sr_channels(sub[slot])[1] for sub in sub_defs], dtype=np.int64)}
                continue
            sup = nd.transformer_def(sup_block)
            attn, mlp, layer = (np.empty(num, dtype=np.int64) for _ in range(3))
            for a, sub in enumerate(sub_defs):
                tdef = nd.transformer_def(sub[slot])
                if tdef.head_dim != sup.head_dim:
                    raise ValueError(f"slot {slot}: head_dim mismatch")
                if not tdef.exists and "layer" not in site:
                    raise ValueError(f"slot {slot}: candidate removes a non-removable block")
                attn[a] = tdef.attn_width if tdef.exists else sup.attn_width
                mlp[a] = tdef.ffn_hidden if tdef.exists else sup.ffn_hidden
                layer[a] = sup.embed_dim if tdef.exists else 0
            entry = {"attn": attn, "mlp": mlp}
            if "layer" in site:
                entry["layer"] = layer
            counts["slots"][slot] = entry
        return counts


def build_arch_masks(counts: Optional[Dict], network_def: Sequence, batch: int,
                     device=None) -> Optional[Dict]:
    """Turn a keep-count tree into the mask tree the model consumes.

    ``"counts"`` mirrors the count tree with each site's ``(batch,)`` int32
    per-example keep counts. The boolean ``(batch, 1, C)`` masks sit beside
    them at ``"embed"`` and ``"slots"``: for every site where the counts lie
    on the CPU, and only for the sites a masked layer norm reads (the embed
    and spatial-reduction sites) where they take the kernels' route
    (``ops.prefix_mask.kernel_route``), whose blocks read the counts."""
    if counts is None:
        return None

    def per_example(count_arr):
        return expand_arch_counts(torch.as_tensor(count_arr, device=device),
                                  batch).to(torch.int32)

    masks = {"embed": None, "slots": {}, "counts": {"embed": None, "slots": {}}}
    if counts.get("embed") is not None:
        n = masks["counts"]["embed"] = per_example(counts["embed"])
        masks["embed"] = make_channel_mask(n, nd.embed_channels(network_def[0]))
    for slot, site in counts.get("slots", {}).items():
        block = network_def[slot]
        if nd.block_type(block) == nd.SPATIAL_REDUCTION:
            n = per_example(site["embed"])
            masks["counts"]["slots"][slot] = {"embed": n}
            masks["slots"][slot] = {"embed": make_channel_mask(n, nd.sr_channels(block)[1])}
            continue
        tdef = nd.transformer_def(block)
        widths = {"attn": tdef.attn_width, "mlp": tdef.ffn_hidden, "layer": tdef.embed_dim}
        entry = {k: per_example(site[k]) for k in widths if site.get(k) is not None}
        masks["counts"]["slots"][slot] = entry
        if not prefix_mask.kernel_route(entry["attn"]):
            masks["slots"][slot] = {k: make_channel_mask(n, widths[k]) for k, n in entry.items()}
    return masks
