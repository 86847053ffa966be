"""Evolutionary-search CLI of the port (reference ``evo_search.py`` parity).

    python -m vit_search_torch.cli.evo_search --data-path ... --model-path ... [flags]

Port of vit_search_tpu/cli/evo_search.py with the same flags (population
500, 20 iterations, 75 parents, 75 mutations + 75 crossovers, mutate prob
0.3, ``--constraint-value`` in MACs), plus ``--device`` (the card unless
``cpu`` is asked for). Per-iteration population pickles and text dumps, a
running ``summary.txt`` of the best individual and the ``history.csv`` are
written as the JAX CLI writes them. Candidates are scored as masked
batched supernet inference (``search.BatchedSupernetEvaluator``) on the
held-out sub-val split.

The proposals come from the port's Python generators: under one seed they
equal the JAX package's ``PopulationEvolver(backend="python")``. The JAX
CLI takes its native (C++) generators whenever g++ builds them, which
draw other candidates under the same seed.
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import time


def get_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("vit-search-torch evolutionary search", add_help=False)
    parser.add_argument("--data-path", required=True, type=str)
    parser.add_argument("--data-set", default="IMNET", type=str)
    parser.add_argument("--val-bs", default=256, type=int)
    parser.add_argument("--num_workers", default=10, type=int)
    parser.add_argument("--input-size", default=224, type=int)
    parser.add_argument("--seed", default=0, type=int)

    parser.add_argument("--model", default="flexible_vit_sr_patch14_224_patch_output",
                        type=str)
    parser.add_argument("--model-path", required=True, type=str,
                        help="trained supernet checkpoint directory")
    parser.add_argument("--network-def", required=True, type=str,
                        help="largest network_def (supernet architecture)")
    parser.add_argument("--search-space", required=True, type=str)

    parser.add_argument("--constraint-value", required=True, type=float,
                        help="MAC constraint")
    parser.add_argument("--search-iter", default=20, type=int)
    parser.add_argument("--init-popu-size", default=500, type=int)
    parser.add_argument("--parent-size", default=75, type=int)
    parser.add_argument("--mutate-size", default=75, type=int)
    parser.add_argument("--mutate-prob", default=0.3, type=float)

    parser.add_argument("--patch-size", default=None, type=int,
                        help="stem patch size (default: inferred from model name)")
    parser.add_argument("--arch-batch", default=8, type=int,
                        help="candidates scored per batched forward")
    parser.add_argument("--score-head", default="auto",
                        choices=["auto", "cls", "dst", "joint"],
                        help="fitness logits; 'auto' mirrors the reference "
                             "(dst_acc1 for distill supernets, acc1 "
                             "otherwise, evo_search.py:280-285)")
    parser.add_argument("--output_dir", default="")
    parser.add_argument("--print-freq", default=100, type=int)
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no-bf16", action="store_false", dest="bf16")
    parser.add_argument("--max-eval-batches", default=None, type=int,
                        help="truncate sub-val evaluation (smoke tests)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card) or 'cpu'; there is no fallback")
    return parser


def write_results(path: str, history) -> None:
    """CSV of (rank, score, network_def) per individual (evo_search.py:143-157)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["rank", "score", "network_def"])
        for rank, ind in enumerate(history):
            writer.writerow([rank, ind.score, repr(ind.network_def)])


def main(args) -> dict:
    import itertools

    import numpy as np
    import torch

    from .. import arch, data, models, train, utils
    from ..device import resolve_device
    from ..models.supernet import SupernetSchedules
    from ..search import BatchedSupernetEvaluator, PopulationEvolver

    device = resolve_device(args.device)
    logger = utils.file_logger(args.output_dir or None, is_master=True)
    logger.info(str(args))
    np.random.seed(args.seed)

    network_def = arch.parse_network_def(args.network_def)
    space = arch.get_space(args.search_space)

    # the held-out sub-val split (reference: 25 images per class), every
    # image scored exactly once for every candidate (reference
    # datasets.py:154-184 pads so that all images are scored; the validity
    # mask also drops the padding rows)
    dataset_val = data.build_dataset(False, data_set=args.data_set, data_path=args.data_path,
                                     transform=data.EvalTransform(size=args.input_size),
                                     use_holdout=True)
    sampler = data.ShardedSampler(len(dataset_val), 1, 0, shuffle=False)
    padded = data.PaddedEvalLoader(
        data.DataLoader(dataset_val, sampler, args.val_bs, num_workers=args.num_workers,
                        drop_last=False), sampler.num_valid_samples)

    class SubVal:
        def __iter__(self):
            batches = iter(padded)
            try:
                yield from itertools.islice(batches, args.max_eval_batches or None)
            finally:
                batches.close()   # ends the loader's workers when truncated

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = models.create_model(args.model, network_def=network_def,
                                num_classes=dataset_val.num_classes,
                                img_size=args.input_size, dtype=dtype, device=device)
    raw = train.restore_raw(args.model_path, map_location=device)
    model.load_state_dict({**raw["params"], **raw["batch_stats"]}, strict=True)

    schedules = SupernetSchedules(network_def, space, example_per_arch=1,
                                  num_warmup_epochs=0, arch_mode="multi")
    evaluator = BatchedSupernetEvaluator(model, schedules, SubVal(), arch_batch=args.arch_batch,
                                         score_head=args.score_head, device=device)
    logger.info(f"Scoring candidates by '{evaluator.score_head}' accuracy")

    patch_size = args.patch_size or (14 if "patch14" in args.model else 16)
    estimator = arch.ComputationEstimator(
        distill="distill" in args.model, input_resolution=args.input_size,
        patch_size=patch_size)
    evolver = PopulationEvolver(network_def, space, args.constraint_value, estimator,
                                seed=args.seed)

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)

    best_per_iter = []
    t_search = time.time()
    for search_iter in range(args.search_iter):
        t_iter = time.time()
        if search_iter == 0:
            evolver.random_sample(args.init_popu_size)
        else:
            evolver.evolve_sample(parent_size=args.parent_size,
                                  mutate_prob=args.mutate_prob,
                                  mutate_size=args.mutate_size)

        defs = [ind.network_def for ind in evolver.popu]
        scores = evaluator.score(defs, progress=logger.info)
        for ind, score in zip(evolver.popu, scores):
            ind.score = float(score)

        if args.output_dir:
            with open(os.path.join(args.output_dir,
                                   f"iter@{search_iter}_popu.pickle"), "wb") as f:
                pickle.dump([(ind.network_def, ind.score) for ind in evolver.popu], f)
            with open(os.path.join(args.output_dir, f"iter@{search_iter}_popu.txt"), "w") as f:
                for ind in evolver.popu:
                    f.write(f"{ind}\n")

        evolver.update_history()
        evolver.sort_history()
        best = evolver.best()
        best_per_iter.append(best.score)
        logger.info(f"Iter {search_iter}: best acc1 = {best.score:.3f}, "
                    f"time = {time.time() - t_iter:.1f}s")
        if args.output_dir:
            with open(os.path.join(args.output_dir, "summary.txt"), "a") as f:
                f.write(f"iter {search_iter}: score={best.score:.4f} "
                        f"mac={estimator(best.network_def)} "
                        f"def={best.network_def}\n")
            write_results(os.path.join(args.output_dir, "history.csv"), evolver.history_popu)

    logger.info(f"Search time: {time.time() - t_search:.1f}s")
    best = evolver.best()
    logger.info(f"Best: {best}")
    return {"best_network_def": best.network_def, "best_score": best.score,
            "best_per_iter": best_per_iter}


if __name__ == "__main__":
    parser = argparse.ArgumentParser("vit-search-torch evo search", parents=[get_args_parser()])
    main(parser.parse_args())
