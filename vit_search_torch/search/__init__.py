"""Evolutionary NAS: generators, evolver, batched supernet scoring."""

from . import batched_eval, evolver, generators
from .batched_eval import BatchedSupernetEvaluator, make_tiled_correct_step
from .evolver import Individual, PopulationEvolver
from .generators import (crossover_network_def, gen_random_network_def,
                         mutate_network_def, prune_random_one, reduce_constraint)

__all__ = [
    "BatchedSupernetEvaluator",
    "Individual",
    "PopulationEvolver",
    "batched_eval",
    "crossover_network_def",
    "evolver",
    "gen_random_network_def",
    "generators",
    "make_tiled_correct_step",
    "mutate_network_def",
    "prune_random_one",
    "reduce_constraint",
]
