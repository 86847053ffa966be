"""Readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--side program|fp8|int8|half_batch]

``program`` drives the program through what a run compares (a train
cell's checked steps; a search cell's first chunk) and holds it to the
reference: the lower readings. ``fp8`` and ``int8`` put the reference in the
program's place, computed with float8 or int8 operands (a cell's control,
named in its limits file); ``half_batch`` puts there the reference with
half of each batch left out and the loss's mean taken over the rest (a
planted fault of a train cell). Each seed prints one JSON line with every
number compared; the last line gives, per number, the largest reading.
"""

import os
import sys
import time

T_START = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def search_readings(run, side: str):
    from benchlib import harness
    from reference import quant

    driver = harness.load_module(os.path.join(run.here, "drivers", "search.py"),
                                 "bench_driver_search")
    model, weights = driver.build_model(run)
    images, valid = driver.sub_val(run)
    index, candidate = driver.checked_candidate(run)
    reference = driver.reference_predictions(run, weights, candidate, images)
    if side == "program":
        evaluator = driver.build(run, model, images, reference[0], valid)
        evo = driver.evolver(run)
        evo.random_sample(run.mix["flags"]["arch_batch"])
        defs = [ind.network_def for ind in evo.popu]
        scored = list(zip(defs, evaluator().score(defs)))
        return driver.numbers(run, scored, index, candidate, reference, valid)
    got = driver.reference_predictions(run, weights, candidate, images, quant.QUANTS[side])[0]
    wrong = int(((got != reference[0]).float() * valid).sum())
    return {"logit_error": (driver.logit_error(wrong, reference[1], reference[2], valid),
                             f"candidate {index}, {wrong} images")}


def readings(run, side: str):
    import gc

    import numpy as np

    import torch
    from benchlib import compare, draws as D, harness, shapes
    from reference import quant, train as ref_train

    driver = harness.load_module(os.path.join(run.here, "drivers", "train.py"),
                                 "bench_driver_train")
    f, cfg = run.mix["flags"], run.config
    net = shapes.to_tuple(cfg["network_def"])
    n_check, spe = run.mix["check_steps"], driver.steps_per_epoch(run)
    start = run.mix["epoch"] * spe
    images, labels = D.make_images(run.seed, run.mix["resident_batches"], f["batch_size"],
                                   f["input_size"],
                                   cfg["num_classes"], run.device)
    if side == "program":
        step, schedules, named, leaf_shapes = driver.build(run)
        host_rng = np.random.default_rng((run.seed % 2**63, run.mix["epoch"]))
        got, packed = driver.checked_steps(run, step, schedules, named, images, labels,
                                           host_rng)
        del step, named
        gc.collect()
        torch.cuda.empty_cache()
    else:
        leaf_shapes, packed = driver.build_shapes_and_counts(run)
    p0 = D.make_weights(leaf_shapes, run.seed, run.device)
    batches = [(images[k], labels[k], packed[k], driver.step_draws(run, k))
               for k in range(n_check)]
    if side != "program":
        kwargs = ({"quant": quant.QUANTS[side]} if side in quant.QUANTS
                  else {"rows": f["batch_size"] // 2})
        got = ref_train.run_steps(p0, batches, f, net, cfg.get("space"), cfg["num_classes"],
                                  start, spe, **kwargs)
    ref = ref_train.run_steps(p0, batches, f, net, cfg.get("space"), cfg["num_classes"],
                              start, spe)
    return compare.train_numbers(got, ref)


def main() -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--side", default="program",
                        choices=("program", "fp8", "int8", "half_batch"))
    args = parser.parse_args()
    sys.path[:0] = [ROOT, BENCH_DIR]
    from benchlib import harness

    worst: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.make_run(ROOT, args.workload, seed, 0.0, False, "cuda", t0)
        numbers = (search_readings if run.mix["kind"] == "search" else readings)(run, args.side)
        line = {"workload": args.workload, "side": args.side, "seed": seed,
                "seconds": time.perf_counter() - t0,
                **{k: {"value": v, "at": w} for k, (v, w) in numbers.items()}}
        print(json.dumps(line), flush=True)
        for k, (v, _) in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
    print(json.dumps({"workload": args.workload, "side": args.side, "largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
