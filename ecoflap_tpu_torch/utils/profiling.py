"""Timing and tracing (port of ``ecoflap_tpu/utils/profiling.py``): the
reference's ``print_time`` decorator (compression/pruners/utils.py:6-18),
named accumulating ``Timer``s, and ``trace``, a ``torch.profiler`` run that
writes a Chrome trace to ``log_dir``. The clocks are read after a
synchronise of the card, so they hold the card's queued work.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def print_time(func):
    """Print a function's wall-clock (compression/pruners/utils.py:6-18)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        _sync()
        start = time.time()
        out = func(*args, **kwargs)
        _sync()
        print(f"{func.__name__} spent {time.time() - start:.3f} s")
        return out

    return wrapper


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = "ecoflap"):
    """``torch.profiler`` over the block, CPU and (with a card) CUDA
    activity, its Chrome trace written to ``log_dir/<name>.json``; a no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        with record_function(name):
            yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


class Timer:
    """Accumulating named timers for phase breakdowns."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync()
        t0 = time.time()
        try:
            yield
        finally:
            _sync()
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def summary(self) -> str:
        return "  ".join(f"{k}: {v:.2f}s" for k, v in self.totals.items())
