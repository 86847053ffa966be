"""Readings that the SwinV2 train cell's limits are set from (not run by the
benchmark's own runs); ``calibrate.py``'s counterpart for the
``swin_train`` driver.

    python3 benchmark/calibrate_swin.py --workload swinv2_base.train \
        --seeds 1 2 3 ... [--side program|fp8|half_batch]

``program`` drives the program through the cell's checked steps and holds
them to the reference: the lower readings. ``fp8`` puts the reference in
the program's place, computed with float8 (e4m3) operands and residual
stream (the cell's control); ``half_batch`` the reference with half of
each batch left out and the loss's mean taken over the rest (a planted
fault). Each seed prints one JSON line with every number compared and
``correct``, the verdict of ``compare.judge`` under the committed
``limits/<cell>.json``; the last line gives, per number, the largest
reading and, over the seeds, the least, and how many seeds were correct.
"""

import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def readings(run, side: str):
    import gc

    import torch
    from benchlib import compare, draws as D, harness
    from reference import quant

    driver = harness.load_module(os.path.join(run.here, "drivers", "swin_train.py"),
                                 "bench_driver_swin_train")
    f, cfg = run.mix["flags"], run.config
    images, labels = D.make_images(run.seed, run.mix["resident_batches"], f["batch_size"],
                                   f["input_size"], cfg["num_classes"], run.device)
    if side == "program":
        step, named, leaf_shapes = driver.build(run)
        got = driver.checked_steps(run, step, named, images, labels)
        del step, named
        gc.collect()
        if run.device == "cuda":
            torch.cuda.empty_cache()
    else:
        leaf_shapes = driver.build_shapes(run)
        kwargs = ({"quant": quant.QUANTS[side]} if side in quant.QUANTS
                  else {"rows": f["batch_size"] // 2})
        got = driver.reference(run, leaf_shapes, images, labels, **kwargs)
    ref = driver.reference(run, leaf_shapes, images, labels)
    return compare.train_numbers(got, ref)


def main() -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", default="swinv2_base.train")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--side", default="program", choices=("program", "fp8", "half_batch"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path[:0] = [ROOT, BENCH_DIR]
    from benchlib import compare, harness

    worst, least, correct = {}, {}, 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.make_run(ROOT, args.workload, seed, 0.0, False, args.device, t0)
        numbers = readings(run, args.side)
        ok, _ = compare.judge(numbers, run.limits["limits"])
        correct += ok
        line = {"workload": args.workload, "side": args.side, "seed": seed,
                "seconds": time.perf_counter() - t0, "correct": ok,
                **{k: {"value": v, "at": w} for k, (v, w) in numbers.items()}}
        print(json.dumps(line), flush=True)
        for k, (v, _) in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
            least[k] = min(least.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "side": args.side, "largest": worst,
                      "least": least, "correct_seeds": correct, "seeds": len(args.seeds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
