"""Loader utilities (port of ``ecoflap_tpu/data/loaders.py``; reference
LAVIS/lavis/datasets/datasets/dataloader_utils.py:15-127): an endless
epoch-resetting ``IterLoader``, a ``MultiIterLoader`` that draws among
loaders by ratio with the JAX module's numpy draws, and the reference's
``PrefetchLoader``, which copies batch N+1 to the card on a side CUDA
stream while batch N computes.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch


class IterLoader:
    """Endless iterator over a re-iterable loader (epoch auto-reset)."""

    def __init__(self, loader_factory: Callable[[], Iterable]):
        self._factory = loader_factory
        self._it = iter(self._factory())
        self.epoch = 0

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self.epoch += 1
            self._it = iter(self._factory())
            return next(self._it)


class MultiIterLoader:
    """Draw among ``loaders`` with probabilities ``ratios``
    (dataloader_utils.py:15-56), from ``np.random.default_rng(seed)``."""

    def __init__(self, loaders: Sequence[IterLoader],
                 ratios: Optional[Sequence[float]] = None, seed: int = 0):
        if ratios is None:
            ratios = [1.0] * len(loaders)
        total = float(sum(ratios))
        self.ratios = [r / total for r in ratios]
        self.loaders = list(loaders)
        self.rng = np.random.default_rng(seed)

    def __next__(self):
        idx = int(self.rng.choice(len(self.loaders), p=self.ratios))
        return next(self.loaders[idx])

    def __iter__(self):
        return self


def _to(batch: Any, device: torch.device, non_blocking: bool) -> Any:
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=non_blocking)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device, non_blocking=non_blocking)
    if isinstance(batch, dict):
        return {k: _to(v, device, non_blocking) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to(v, device, non_blocking) for v in batch)
    return batch


def _tensors(batch: Any):
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, dict):
        for v in batch.values():
            yield from _tensors(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _tensors(v)


class PrefetchLoader:
    """Batches on ``device``, one ahead: on the card batch N+1 is copied on
    a side stream while batch N computes (dataloader_utils.py:59-103), and
    the compute stream waits for the copy before it reads it; on the CPU the
    batches come in order, converted."""

    def __init__(self, loader: Iterable, device="cpu"):
        self.loader = loader
        self.device = torch.device(device)

    def __iter__(self):
        it = iter(self.loader)
        if self.device.type != "cuda":
            for batch in it:
                yield _to(batch, self.device, False)
            return
        stream = torch.cuda.Stream(self.device)

        def load(batch):
            with torch.cuda.stream(stream):
                return _to(batch, self.device, True)

        try:
            nxt = load(next(it))
        except StopIteration:
            return
        def ready(batch):
            # the compute stream waits for the copy, and the allocator keeps
            # the batch's memory until the compute stream is done with it
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(stream)
            for t in _tensors(batch):
                t.record_stream(main)
            return batch

        for batch in it:
            cur, nxt = ready(nxt), load(batch)
            yield cur
        yield ready(nxt)
