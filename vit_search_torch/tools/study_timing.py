"""Stage seconds and the loader's share of an accuracy study run.

Reads what ``python -m vit_search_torch.tools.accuracy_study`` printed
(each stage's ``+ <command>`` line, its subprocess's output, then the
stage's ``[Ns]``) and prints one JSON object: for each stage its label and
seconds, and for each training epoch the CLI's throughput line and the
averages of its last step line over the epoch's last 20 steps: ``step_s``
(one pass of the host loop) and ``data_s`` (its wait for the next batch).
``loader_share`` is the share of the epoch's time beyond its steps at that
steady step time, ``1 - step_s * imgs_per_s / batch``: the loop waiting on
the loader, which decodes ahead once it leads, so the last steps' own wait
(``data_s``) understates it.

Usage: python -m vit_search_torch.tools.study_timing STUDY_STDOUT
"""

from __future__ import annotations

import json
import re
import sys
from typing import Dict, List

_STAGE_SECONDS = re.compile(r"^  \[(\d+)s\]$")
_STEP = re.compile(r"Epoch: \[(\d+)\] \[(\d+)/(\d+)\].*time: ([\d.]+)  data: ([\d.]+)")
_THROUGHPUT = re.compile(r"Epoch: \[(\d+)\] throughput: ([\d.]+) imgs/s "
                         r"\((\d+) steps, global batch (\d+)\)")


def stage_label(cmd: List[str]) -> str:
    """``cli.train supernet``, ``cli.evo_search``, ``cli.train --eval``, ..."""
    module = cmd[cmd.index("-m") + 1].split(".", 1)[1] if "-m" in cmd else cmd[0]
    if "--eval" in cmd:
        return f"{module} --eval"
    if "--output_dir" in cmd and module == "cli.train":
        return f"{module} {cmd[cmd.index('--output_dir') + 1].rstrip('/').rsplit('/', 1)[-1]}"
    return module


def parse(text: str) -> Dict:
    stages, stage = [], None
    for line in text.splitlines():
        if line.startswith("+ "):
            stage = {"stage": stage_label(line[2:].split()), "epochs": {}}
            continue
        if stage is None:
            continue
        m = _STAGE_SECONDS.match(line)
        if m:
            stage["seconds"] = int(m.group(1))
            stage["epochs"] = [stage["epochs"][k] for k in sorted(stage["epochs"])]
            stages.append(stage)
            stage = None
            continue
        m = _STEP.search(line)
        if m and int(m.group(2)) == int(m.group(3)) - 1:
            stage["epochs"].setdefault(int(m.group(1)), {}).update(
                step_s=float(m.group(4)), data_s=float(m.group(5)))
        m = _THROUGHPUT.search(line)
        if m:
            epoch = stage["epochs"].setdefault(int(m.group(1)), {})
            epoch.update(imgs_per_s=float(m.group(2)), steps=int(m.group(3)),
                         batch=int(m.group(4)))
            if "step_s" in epoch and epoch["imgs_per_s"]:
                epoch["loader_share"] = max(
                    0.0, 1.0 - epoch["step_s"] * epoch["imgs_per_s"] / epoch["batch"])
    return {"stages": stages, "seconds": sum(s["seconds"] for s in stages)}


def main() -> None:
    with open(sys.argv[1]) as f:
        print(json.dumps(parse(f.read())))


if __name__ == "__main__":
    main()
