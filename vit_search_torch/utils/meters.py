"""Windowed metric meters with cross-process synchronization.

Port of vit_search_tpu/utils/meters.py, the reference observability layer
(utils.py:24-205): ``SmoothedValue`` keeps a sliding window plus global
totals; ``MetricLogger.log_every`` wraps an iterable with iter/data timing,
ETA and periodic log lines. Cross-process sync is the ``all_reduce``
parameter of ``synchronize_between_processes`` (a sum of a float64 vector
over processes); its default is the identity, the sum over one process.
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np


class SmoothedValue:
    """Track a series with a sliding window and global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.window.append(float(value))
        self.count += n
        self.total += float(value) * n

    def sync(self, all_reduce=None) -> None:
        """Synchronize count/total across processes (window stays local)."""
        if all_reduce is None:
            return
        total, count = all_reduce(np.array([self.total, float(self.count)]))
        self.total, self.count = float(total), int(count)

    @property
    def median(self) -> float:
        return float(np.median(self.window)) if self.window else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.window)) if self.window else 0.0

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def _default_all_reduce(x: np.ndarray) -> np.ndarray:
    """One process: the sum over processes is the value itself. The
    multi-process runs pass their own sum (``torch.distributed``)."""
    return x


class MetricLogger:
    def __init__(self, delimiter: str = "  ", logger=None):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self._print = logger.info if logger is not None else print

    def update(self, n: int = 1, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n=n)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __getattr__(self, name: str):
        meters = self.__dict__.get("meters", {})
        if name in meters:
            return meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self, all_reduce=_default_all_reduce) -> None:
        for meter in self.meters.values():
            meter.sync(all_reduce)

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None) -> Iterator:
        total = total if total is not None else len(iterable)  # type: ignore[arg-type]
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = start
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * (total - i - 1)
                self._print(
                    f"{header} [{i}/{total}]  eta: "
                    f"{datetime.timedelta(seconds=int(eta))}  {self}  "
                    f"time: {iter_time}  data: {data_time}")
        elapsed = time.time() - start
        self._print(f"{header} Total time: "
                    f"{datetime.timedelta(seconds=int(elapsed))} "
                    f"({elapsed / max(total, 1):.4f} s / it)")

    def averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}
