"""Population-based evolutionary search over ``network_def`` candidates.

Port of the JAX package's ``search/evolver.py`` (itself the reference
evolver, search_utils/evolver.py:13-116): a population of deduplicated
``Individual``s, random init, then per-iteration mutation from a random
top-``parent_size`` parent plus uniform crossover of two distinct parents,
with a skip-checking escape hatch once crossover stops producing novel
candidates.

Scoring is the caller's (``search.batched_eval`` scores candidates on the
supernet). The proposals come from the native (C++) generators of
``vit_search_torch.native`` where g++ builds them, else from the pure-Python
ones in ``search.generators``, as in the JAX package's evolver.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .. import native as native_mod
from ..arch import network_def as nd
from . import generators

_CROSSOVER_SKIP_CHECKING_THRESHOLD = 100
BACKENDS = ("auto", "python", "native")


@dataclasses.dataclass
class Individual:
    network_def: nd.NetworkDef
    score: float = -1.0

    def __lt__(self, other: "Individual") -> bool:
        return self.score < other.score

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Individual) and self.network_def == other.network_def

    def __repr__(self) -> str:
        return f"(network_def={self.network_def}, score={self.score})"


class PopulationEvolver:
    """Under the same seed and backend the populations equal the JAX
    package's ``PopulationEvolver``."""

    def __init__(self, largest_network_def: Sequence, num_channels_to_keep: Sequence,
                 constraint: float, compute_resource: generators.ResourceFn,
                 *, seed: Optional[int] = None, backend: str = "auto"):
        """``backend``: 'auto' uses the native (C++) proposal generators when
        the library builds, 'python' forces the reference-semantics
        pure-Python path, 'native' requires the library. Either native
        choice drops to Python when the native cost model disagrees with
        ``compute_resource`` on the largest net. ``self.backend`` names the
        generators taken."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.largest_network_def = nd.to_immutable(largest_network_def)
        self.num_channels_to_keep = num_channels_to_keep
        self.constraint = constraint
        self.compute_resource = compute_resource
        self.rng = np.random.default_rng(seed)

        self.native = None
        if backend in ("auto", "native"):
            if native_mod.available():
                est = compute_resource
                self.native = native_mod.NativeSearchOps(
                    self.largest_network_def, num_channels_to_keep, constraint,
                    distill=getattr(est, "distill", False),
                    input_resolution=getattr(est, "input_resolution", 224),
                    patch_size=getattr(est, "patch_size", 14))
                # guard: the native cost model must agree exactly
                if (self.native.estimate_mac(self.largest_network_def)
                        != compute_resource(self.largest_network_def)):
                    self.native = None
            elif backend == "native":
                raise RuntimeError("native backend requested but unavailable: "
                                   f"{native_mod.load_error()}")
        self.backend = "python" if self.native is None else "native"

        self.popu: List[Individual] = []          # current (unscored) generation
        self.history_popu: List[Individual] = []  # every scored individual, deduped

    def _seed(self) -> int:
        return int(self.rng.integers(2 ** 63))

    def _gen_random(self) -> nd.NetworkDef:
        if self.native is not None:
            return self.native.gen_random(self._seed())
        return generators.gen_random_network_def(
            self.largest_network_def, self.num_channels_to_keep,
            self.constraint, self.compute_resource, rng=self.rng)

    def _mutate(self, parent: nd.NetworkDef, m_prob: float) -> nd.NetworkDef:
        if self.native is not None:
            return self.native.mutate(parent, m_prob, self._seed())
        return generators.mutate_network_def(
            parent, self.num_channels_to_keep, m_prob,
            self.constraint, self.compute_resource, rng=self.rng)

    def _crossover(self, m: nd.NetworkDef, f: nd.NetworkDef) -> nd.NetworkDef:
        if self.native is not None:
            return self.native.crossover(m, f, self._seed())
        return generators.crossover_network_def(
            m, f, self.num_channels_to_keep,
            self.constraint, self.compute_resource, rng=self.rng)

    # -- membership uses network_def equality, like the reference Individual.__eq__
    def _is_novel(self, ind: Individual) -> bool:
        return ind not in self.popu and ind not in self.history_popu

    def random_sample(self, num_samples: int) -> None:
        """Fill the generation with novel random in-band candidates."""
        count = 0
        while count < num_samples:
            ind = Individual(self._gen_random())
            if self._is_novel(ind):
                self.popu.append(ind)
                count += 1

    def update_history(self) -> None:
        for ind in self.popu:
            if ind not in self.history_popu:
                self.history_popu.append(ind)
        self.popu = []

    def sort_history(self) -> None:
        self.history_popu.sort(reverse=True)

    def evolve_sample(self, parent_size: int, mutate_prob: float, mutate_size: int,
                      crossover_size: Optional[int] = None) -> None:
        """One generation: ``mutate_size`` mutations + ``crossover_size`` crossovers."""
        if self.popu:
            raise RuntimeError("evolve_sample called with unscored population pending")
        if not self.history_popu:
            raise RuntimeError("history is empty; call random_sample/update_history first")
        if parent_size > len(self.history_popu):
            raise ValueError("parent_size larger than history population")

        self.sort_history()
        if crossover_size is None:
            crossover_size = mutate_size

        count = 0
        while count < mutate_size:
            parent = self.history_popu[int(self.rng.integers(parent_size))]
            ind = Individual(self._mutate(parent.network_def, mutate_prob))
            if self._is_novel(ind):
                self.popu.append(ind)
                count += 1

        count = 0
        skip_counter = 0
        while count < crossover_size:
            idx = self.rng.choice(parent_size, size=2, replace=False)
            m = self.history_popu[int(idx[0])].network_def
            f = self.history_popu[int(idx[1])].network_def
            ind = Individual(self._crossover(m, f))
            if self._is_novel(ind) or skip_counter >= _CROSSOVER_SKIP_CHECKING_THRESHOLD:
                self.popu.append(ind)
                count += 1
                skip_counter = 0
            else:
                skip_counter += 1

    def best(self) -> Individual:
        self.sort_history()
        return self.history_popu[0]
