"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, run its traffic's driver, read the per-layer metrics,
and print the result.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``mixes/<traffic>.json``); the mix's ``kind`` names its driver
(``drivers/<kind>.py``), the cell's limits of the numbers compared for
``correct`` are ``limits/<cell>.json``, and each per-layer metric is read
by ``metrics/<metric>.py`` (``read(ctx)``, a number or ``None`` where there
is nothing to read). A new cell, mix, driver or metric is a new file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_search_tpu")


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell's entries and files, the run's
    arguments, and the process's start on the host clock."""

    bench: Dict
    cell: Dict
    config: Dict
    mix: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    here: str = HERE

    def metrics(self, section: str) -> List[Dict]:
        """The entries of ``section`` that this cell reports."""
        name = self.cell["name"]
        return [m for m in self.bench[section] if name in m.get("workloads", [name])]


def log(run: Run, msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"{run.cell['name']} [{time.perf_counter() - run.t_start:.1f} s]: {msg}",
          file=sys.stderr, flush=True)


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_run(root: str, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, here: str = HERE, config: Optional[Dict] = None,
             mix: Optional[Dict] = None, limits: Optional[Dict] = None) -> Run:
    """The run of ``workload`` as ``root/BENCHMARK.json`` names it; a test may
    hand in its own configuration, mix and limits."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
    cell = cells[workload]
    return Run(bench, cell,
               config or load_json(here, "configs", f"{cell['config']}.json"),
               mix or load_json(here, "mixes", f"{cell['traffic']}.json"),
               limits or load_json(here, "limits", f"{workload}.json"),
               seed, seconds, trace, device, t_start, here)


def read_per_layer(run: Run, ctx: Dict) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that its reader finds, with its unit."""
    out = {}
    for m in run.metrics("per_layer"):
        reader = load_module(os.path.join(run.here, "metrics", f"{m['name']}.py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def execute(run: Run) -> Dict:
    """Run the cell's driver; the result line as a dict (``checks`` last)."""
    driver = load_module(os.path.join(run.here, "drivers", f"{run.mix['kind']}.py"),
                         "bench_driver_" + run.mix["kind"])
    out = driver.run(run)
    wanted = run.metrics("end_to_end") if not run.trace else run.metrics("per_layer")
    measured = out["end_to_end"] if not run.trace else read_per_layer(run, out["ctx"])
    metrics = {m["name"]: measured[m["name"]] for m in wanted if m["name"] in measured}
    if not run.trace:
        missing = [m["name"] for m in wanted if m["name"] not in measured]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": out["device"]}
    if run.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def report(result: Dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)
