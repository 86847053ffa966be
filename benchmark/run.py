"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``vit_search_torch``), on a
machine with the cards the cell asks for. ``BENCHMARK.json`` at the root
names the cells; see ``benchlib/harness.py`` for how a cell's files are
found. The last line on standard output is the result, as one JSON object;
with ``--trace 0`` it holds the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics and a breakdown of the device's time. The card's
name and power limit go to standard error first, the numbers compared for
``correct`` beside their limits last.

Exits non-zero, and prints no result, without enough CUDA cards, or where
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def cache_env(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout; no JAX
    backend for libraries that would load one."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache_env(ROOT)
    sys.path[:0] = [ROOT, BENCH_DIR]
    from benchlib import device, harness

    run = harness.make_run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    import torch

    chips = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"card: {device.card_line()}", file=sys.stderr, flush=True)
    torch.cuda.reset_peak_memory_stats()
    result = harness.execute(run)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX was loaded in this process: {loaded}", file=sys.stderr)
        return 4
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
