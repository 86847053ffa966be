"""Multi-process launcher with preemption-safe restart semantics.

Port of vit_search_tpu/cli/launch.py, in the role of the reference
SLURM/submitit launcher (run_with_submitit.py): join the process group, run
training, and on preemption make sure the job can requeue with ``--resume``.

- process coordinates come from the ``torchrun`` environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or the
  ``--coordinator-address/--num-processes/--process-id`` flags, which
  override it; ``parallel.init_distributed`` joins the group over NCCL on
  the card (gloo with ``--device cpu``), one card per process,
  ``cuda:<LOCAL_RANK>``;
- preemption is a SIGTERM from the scheduler: the train loop stops every
  rank at the same step, rank 0 checkpoints, and relaunching the same
  command with ``--resume auto`` continues (reference ``Trainer.checkpoint``
  requeue, run_with_submitit.py:62-72).

Usage, on each host::

    torchrun --nproc-per-node N -m vit_search_torch.cli.launch <train args...>
"""

from __future__ import annotations

import argparse
import os
import sys


def torchrun_process_env() -> dict:
    """Process coordinates from the ``torchrun`` environment."""
    env = os.environ
    coords = {}
    if "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coords["coordinator_address"] = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "WORLD_SIZE" in env:
        coords["num_processes"] = int(env["WORLD_SIZE"])
    if "RANK" in env:
        coords["process_id"] = int(env["RANK"])
    if "LOCAL_RANK" in env:
        coords["local_rank"] = int(env["LOCAL_RANK"])
    return coords


def process_coords(launcher_args) -> dict:
    """The environment's coordinates, each flag given overriding its own."""
    coords = torchrun_process_env()
    if launcher_args.coordinator_address:
        coords["coordinator_address"] = launcher_args.coordinator_address
    if launcher_args.num_processes is not None:
        coords["num_processes"] = launcher_args.num_processes
    if launcher_args.process_id is not None:
        coords["process_id"] = launcher_args.process_id
    return coords


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser("vit-search-torch launcher")
    parser.add_argument("--coordinator-address", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    launcher_args, train_argv = parser.parse_known_args(argv)

    from .train import get_args_parser, main as train_main

    train_parser = argparse.ArgumentParser(parents=[get_args_parser()])
    args = train_parser.parse_args(train_argv)

    from .. import parallel

    coords = process_coords(launcher_args)
    parallel.init_distributed(coords.get("coordinator_address"),
                              coords.get("num_processes"), coords.get("process_id"),
                              local_rank=coords.get("local_rank"), device=args.device)
    try:
        if not args.resume:
            args.resume = "auto"  # preemption requeue: continue if a ckpt exists
            try:
                train_main(args)
                return 0
            except FileNotFoundError:
                args.resume = ""
        train_main(args)
        return 0
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    sys.exit(main())
