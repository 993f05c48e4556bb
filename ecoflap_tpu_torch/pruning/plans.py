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
``batch_size`` (``first_order._streamed_block_grads``): it prepares each
microbatch's stack inputs itself and never builds the rolling cache.

The lane ensemble (``lane_paths``, ``lane_losses``; port of
``SuffixPlan.make_lane_scorer``, plans.py:217-351) scores K targets of one
block together: lane k runs block ``start`` with its target replaced by a
perturbed copy (``torch.func.functional_call``, the model is never
written), then blocks ``start+1..`` and ``finish_fn`` run once on the K
lanes' outputs stacked along the batch, with the shared weights.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

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


def repeat_batch(tree: Any, k: int, batch_size: int) -> Any:
    """Every tensor of ``tree`` whose leading dimension is ``batch_size``
    tiled ``k`` times along it (lane-major: lane 0's samples first); the rest
    (shared biases and tables, which lead with 1) rides whole."""
    if isinstance(tree, torch.Tensor):
        if tree.ndim >= 1 and tree.shape[0] == batch_size:
            return tree.repeat(k, *([1] * (tree.ndim - 1)))
        return tree
    if isinstance(tree, tuple):
        return tuple(repeat_batch(v, k, batch_size) for v in tree)
    if isinstance(tree, dict):
        return {n: repeat_batch(v, k, batch_size) for n, v in tree.items()}
    return tree


class _BlockCall(nn.Module):
    """One block through its stack's ``block_forward``, as a module that
    ``functional_call`` can rebind parameters of (under ``block.``)."""

    def __init__(self, stack: StackSpec, block: nn.Module) -> None:
        super().__init__()
        self.stack = stack
        self.block = block

    def forward(self, x: torch.Tensor, cache: Any) -> torch.Tensor:
        return self.stack.block_forward(self.block, x, cache, None)[0]


class SuffixPlan:
    """Rolling-prefix plan for one stack.

    Args:
      stack: the stack whose targets the plan serves.
      finish_fn: (model, stack_output, data) -> (B,) per-sample losses.
      model: the model, unperturbed when the cache is built.
      batch: the coarse calibration batch.
      batch_keys: batch fields finish_fn reads (default all).
      extra_data: further batch-leading tensors for finish_fn.
      lanes: whether MeZO scores this stack's targets by the lane ensemble
        when its caller leaves the choice to the plan (``mezo_leaf_scores``,
        ``ensemble=None``). A model whose suffix is already compute-bound at
        one lane gains nothing from stacking lanes and pays their
        activations in memory; it says False and takes the serial cycle.
      finish_lanes: lanes per ``finish_fn`` call in the lane ensemble (None:
        all at once). A model whose finish holds large per-sample tensors
        (LLaMA's float32 logits, 0.26 GB a 2048-token window at 32000
        words) finishes lane by lane; the losses are the same.
    """

    static_keys = (START_KEY,)

    def __init__(self, stack: StackSpec,
                 finish_fn: Callable[[nn.Module, torch.Tensor, Dict], torch.Tensor],
                 model: nn.Module, batch: Dict[str, torch.Tensor],
                 batch_keys: Optional[Sequence[str]] = None,
                 extra_data: Optional[Dict[str, Any]] = None,
                 lanes: bool = True,
                 finish_lanes: Optional[int] = None) -> None:
        self.stack = stack
        self.lanes = lanes
        self.finish_lanes = finish_lanes
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

    # -- lane ensemble (mezo.py groups a block's targets) ----------------------
    def lane_paths(self, targets: Sequence[Any]) -> Tuple[str, ...]:
        """In-block parameter paths of same-block targets, e.g.
        ``attn.qkv.weight``."""
        return tuple(f"{t.local}.weight" for t in targets)

    def lane_losses(self, model: nn.Module, data: Dict[str, Any],
                    paths: Sequence[str],
                    weights: Sequence[torch.Tensor]) -> torch.Tensor:
        """(K, b) per-sample losses of K lanes on one slice of the eval
        data (``data`` as ``prepare`` returns it, cut to b samples): lane k
        evaluates the model with ``paths[k]`` of block ``data[START_KEY]``
        replaced by ``weights[k]``. The first block runs once per lane; the
        suffix runs once on the K lanes' outputs concatenated along the batch,
        with its batch-leading cache and the finish's data repeated K times."""
        blocks = self.stack.blocks(model)
        start, x, cache = data[START_KEY], data[X_KEY], data[CACHE_KEY]
        b, k = x.shape[0], len(paths)
        call = _BlockCall(self.stack, blocks[start])
        y = torch.cat([functional_call(call, {f"block.{p}": w}, (x, cache))
                       for p, w in zip(paths, weights)])
        cache_k = repeat_batch(cache, k, b)
        for j in range(start + 1, self.stack.num_blocks):
            y, _ = self.stack.block_forward(blocks[j], y, cache_k, None)
        base = {n: v for n, v in data.items()
                if n not in (X_KEY, CACHE_KEY, START_KEY)}
        step = self.finish_lanes or k
        losses = []
        for l0 in range(0, k, step):
            n = min(step, k - l0)
            losses.append(self.finish_fn(model, y[l0 * b:(l0 + n) * b],
                                         repeat_batch(base, n, b)))
        return torch.cat(losses).reshape(k, b)
