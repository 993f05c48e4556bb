"""Metric logging (port of ``ecoflap_tpu/utils/logger.py``; reference
LAVIS/lavis/common/logger.py:19-188): ``SmoothedValue`` keeps a window and
a global count and total, ``MetricLogger`` a set of them, and
``synchronize_between_processes`` all-reduces the counts and totals over
the default process group, as LAVIS's does.
"""

from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict, deque
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ecoflap_tpu_torch.parallel.dist import is_dist_avail_and_initialized, is_main_process


class SmoothedValue:
    """Windowed median and mean, and the global mean (logger.py:19-78)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        """Sum count and total over every rank (the window stays local)."""
        if not is_dist_avail_and_initialized():
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device="cuda" if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value,
                               count=self.count)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for m in self.meters.values():
            m.synchronize_between_processes()

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = str(datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i))))
                    logging.info(f"{header} [{i}/{total}] eta: {eta} {self}")
                else:
                    logging.info(f"{header} [{i}] {self}")
            i += 1
            end = time.time()
        logging.info(f"{header} Total time: "
                     f"{datetime.timedelta(seconds=int(time.time() - start))}")


def setup_logger(level=logging.INFO) -> None:
    """INFO logging on rank 0, warnings only elsewhere (logger.py:190)."""
    logging.basicConfig(level=level if is_main_process() else logging.WARN,
                        format="%(asctime)s [%(levelname)s] %(message)s")
