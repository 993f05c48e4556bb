"""Suffix-cached MeZO loss plans (port of ``SuffixPlan`` in
``ecoflap_tpu/pruning/plans.py``).

A perturbation confined to block i of a stack cannot change block i's input.
So a plan keeps a rolling cache of block i's input, advanced by one forward
of block i-1 with the unperturbed weights when scoring moves on, and
evaluates only blocks i..L-1 (a Python loop) plus ``finish_fn``, the model's
tail from the stack's output to per-sample losses.

The cache is built from the weights as they are when ``data`` is first read,
so ``mezo_leaf_scores`` reads every plan's ``data`` before it perturbs
anything (plans.py:148-151).

First-order scoring reads only ``stack``, ``finish_fn``, ``base_data`` and
``batch_size`` (``first_order.streamed_plan_grad_sums``): it prepares each
microbatch's stack inputs itself and never builds the rolling cache.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ecoflap_tpu_torch.pruning.adapter import StackSpec

X_KEY = "__suffix_x"
CACHE_KEY = "__suffix_cache"
START_KEY = "__suffix_start"


def leading_dim(tree: Any) -> int:
    """Leading dimension of the first tensor in a dict/tuple tree."""
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    vals = tree.values() if isinstance(tree, dict) else tree
    for v in vals:
        if v is not None and not isinstance(v, (int, float)):
            return leading_dim(v)
    raise ValueError("no tensor in tree")


class SuffixPlan:
    """Rolling-prefix plan for one stack.

    Args:
      stack: the stack whose targets the plan serves.
      finish_fn: (model, stack_output, data) -> (B,) per-sample losses.
      model: the model, unperturbed when the cache is built.
      batch: the coarse calibration batch.
      batch_keys: batch fields finish_fn reads (default all).
      extra_data: further batch-leading tensors for finish_fn.
    """

    static_keys = (START_KEY,)

    def __init__(self, stack: StackSpec,
                 finish_fn: Callable[[nn.Module, torch.Tensor, Dict], torch.Tensor],
                 model: nn.Module, batch: Dict[str, torch.Tensor],
                 batch_keys: Optional[Sequence[str]] = None,
                 extra_data: Optional[Dict[str, Any]] = None) -> None:
        self.stack = stack
        self.finish_fn = finish_fn
        self._prefix = stack.name + "."
        self.batch_size = leading_dim(batch)
        keep = batch_keys if batch_keys is not None else list(batch)
        self._base = {k: batch[k] for k in keep}
        self._base.update(extra_data or {})
        self._model = model
        self._batch: Optional[Dict[str, torch.Tensor]] = batch
        self._x = None
        self._cache = None
        self._block = 0

    def _ensure(self) -> None:
        if self._x is None:
            with torch.no_grad():
                self._x, self._cache = self.stack.prepare_inputs(self._model,
                                                                 self._batch)
            self._batch = None

    @property
    def base_data(self) -> Dict[str, Any]:
        """The batch fields and extra data ``finish_fn`` reads, whole batch
        (plans.py:128-132)."""
        return self._base

    def match(self, name: str) -> bool:
        return name.startswith(self._prefix)

    def loss_fn(self, model: nn.Module, data: Dict[str, Any]) -> torch.Tensor:
        blocks = self.stack.blocks(model)
        y, cache = data[X_KEY], data[CACHE_KEY]
        for j in range(data[START_KEY], self.stack.num_blocks):
            y, _ = self.stack.block_forward(blocks[j], y, cache, None)
        return self.finish_fn(model, y, data)

    @property
    def data(self) -> Dict[str, Any]:
        self._ensure()
        return {**self._base, X_KEY: self._x, CACHE_KEY: self._cache,
                START_KEY: self._block}

    def prepare(self, model: nn.Module, name: str) -> Dict[str, Any]:
        """Advance the cache to the target's block with the current
        (restored) weights and return the eval data."""
        self._ensure()
        i = int(name[len(self._prefix):].split(".", 1)[0])
        if i < self._block:
            raise ValueError(
                f"SuffixPlan targets must arrive in block order: got block {i} "
                f"after {self._block} ({name})")
        blocks = self.stack.blocks(model)
        with torch.no_grad():
            while self._block < i:
                self._x, _ = self.stack.block_forward(
                    blocks[self._block], self._x, self._cache, None)
                self._block += 1
        return self.data
