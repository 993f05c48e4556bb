"""Layer-streaming Wanda fine stage (port of ``_stream_prune_stack`` and
``make_wanda_prune_fn`` in ``ecoflap_tpu/pruning/engine.py``; reference
``T5LayerWandaPruner._prune`` wanda_pruner.py:217-290 and
``VITLayerWandaPruner._prune`` :499-568).

Per stack: build the block-0 inputs once; then per block collect the
per-linear sum of x^2, prune every linear to its ratio in place, and
re-forward the pruned block to make the next block's inputs, so downstream
blocks calibrate against the pruned upstream (:281-285).

Each pass streams the batch in ``num_chunks`` slices and sums the
statistics over them, so activation memory is one slice's; the pruner passes
its microbatch count, as the JAX package's fine stage does by default
(``chunked_block_apply``, pruners.py:298). LLaMA-7B needs it: 128 windows of
2048 tokens in one forward hold two float32 copies of the ``down_proj`` input
alone, 11.5 GB each.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Mapping

import torch
from torch import nn

from ecoflap_tpu_torch.pruning.adapter import StackSpec
from ecoflap_tpu_torch.pruning.mezo import slice_microbatch
from ecoflap_tpu_torch.pruning.wanda import (
    apply_mask,
    mask_per_row,
    mask_per_tensor,
    wanda_metric,
)


def make_wanda_prune_fn(per_row_mask: bool) -> Callable:
    """(w, col_sq_sum, n_seq, ratio) -> boolean prune mask: the Wanda metric
    and the reference's per-row or per-tensor selection."""

    def prune_mask(w, col_sq_sum, n_seq, ratio):
        metric = wanda_metric(w, col_sq_sum.to(torch.float32) / n_seq)
        return (mask_per_row if per_row_mask else mask_per_tensor)(metric, ratio)

    return prune_mask


@torch.no_grad()
def stream_prune_stack(
    stack: StackSpec,
    model: nn.Module,
    batch: Any,
    sparsity_ratio: Mapping[str, float],
    verbose: bool = True,
    num_chunks: int = 1,
) -> nn.Module:
    """Wanda-prune one stack of ``model`` in place, ``num_chunks`` forwards
    per pass (the count must divide the batch)."""
    prune_mask = make_wanda_prune_fn(stack.per_row_mask)
    t0 = time.time()
    x, cache = stack.prepare_inputs(model, batch)
    # a private contiguous copy: the passes below overwrite it slice by slice
    x = x.clone(memory_format=torch.contiguous_format)
    n = x.shape[0]
    n_seq = float(n)
    if n % num_chunks:
        raise ValueError(f"{num_chunks} chunks do not divide the batch of {n}")
    # views into x: each pass overwrites a slice with that slice's output,
    # which depends on that slice's input only
    slices = [(slice_microbatch(x, c, num_chunks, n),
               slice_microbatch(cache, c, num_chunks, n)) for c in range(num_chunks)]
    if verbose:
        print(f"prepared inputs ({stack.name}) +{time.time() - t0:.1f}s")
    blocks = stack.blocks(model)
    for i in range(stack.num_blocks):
        if verbose:
            print(f"pruning block {i} ({stack.name}) +{time.time() - t0:.1f}s")
        block = blocks[i]
        stats = {}
        for xc, cc in slices:
            _, part = stack.block_forward(block, xc, cc, "wanda")
            stats = {k: stats[k] + v if k in stats else v for k, v in part.items()}
        for local in stack.linear_names:
            w = block.get_submodule(local).weight
            ratio = float(sparsity_ratio[stack.weight_key(i, local)])
            apply_mask(w, prune_mask(w, stats[local], n_seq, ratio))
        for xc, cc in slices:
            xc.copy_(stack.block_forward(block, xc, cc, None)[0])
    return model


@torch.no_grad()
def check_stack_sparsity(stack: StackSpec, model: nn.Module,
                         verbose: bool = True) -> float:
    """Zero fraction over a stack's prunable weights
    (T5LayerWandaPruner.check_sparsity, wanda_pruner.py:139-163)."""
    count = total = 0
    for i, block in enumerate(stack.blocks(model)):
        sub_count = sub_total = 0
        for local in stack.linear_names:
            w = block.get_submodule(local).weight
            sub_count += int((w == 0).sum())
            sub_total += w.numel()
        if verbose:
            print(f"layer {i} sparsity {sub_count / sub_total:.6f}")
        count += sub_count
        total += sub_total
    return count / total
