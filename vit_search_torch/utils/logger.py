"""Rank-aware file logger (a copy of vit_search_tpu/utils/logger.py).

Parity with the reference ``FileLogger`` (logger.py:17-66): the main process
logs to the console plus three files in the output directory —
``verbose.log`` (INFO+), ``event.log`` (WARN+), ``debug.log`` (DEBUG+ with
timestamps and file:line) — while other processes get a no-op sink.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


class NoOpLogger:
    def _noop(self, *args, **kwargs):
        return None

    debug = info = warning = error = critical = event = verbose = _noop


def file_logger(output_dir: Optional[str], is_master: bool,
                is_rank0: bool = True, name: str = "vit_search_torch"):
    """Create the process logger (reference logger.py:9-14 entry point)."""
    if not is_rank0:
        return NoOpLogger()
    logger = logging.getLogger(f"{name}.{os.getpid()}")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    logger.propagate = False

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(console)

    if is_master and output_dir:
        os.makedirs(output_dir, exist_ok=True)

        def add_file(filename: str, level: int, fmt: str):
            handler = logging.FileHandler(os.path.join(output_dir, filename))
            handler.setLevel(level)
            handler.setFormatter(logging.Formatter(fmt))
            logger.addHandler(handler)

        add_file("verbose.log", logging.INFO, "%(message)s")
        add_file("event.log", logging.WARNING, "%(message)s")
        add_file("debug.log", logging.DEBUG,
                 "%(asctime)s %(filename)s:%(lineno)d %(levelname)s %(message)s")
    return logger
