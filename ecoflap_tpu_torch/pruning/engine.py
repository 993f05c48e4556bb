"""Layer-streaming fine stage, Wanda or SparseGPT (port of
``_stream_prune_stack``, ``make_wanda_prune_fn`` and
``make_sparsegpt_prune_fns`` in ``ecoflap_tpu/pruning/engine.py``;
reference ``T5LayerWandaPruner._prune`` wanda_pruner.py:217-290,
``VITLayerWandaPruner._prune`` :499-568 and the SparseGPT pruner's
per-layer loop, sparsegpt_pruner.py).

Per stack: build the block-0 inputs once; then per block collect each
linear's statistic (Wanda: the sum of x^2 per input column; SparseGPT: the
Gram matrix X^T X), prune every linear to its ratio in place, and re-forward
the pruned block to make the next block's inputs, so downstream blocks
calibrate against the pruned upstream (:281-285).

Each pass streams the batch in ``num_chunks`` slices and sums the
statistics over them, so activation memory is one slice's; the pruner passes
its microbatch count, as the JAX package's fine stage does by default
(``chunked_block_apply``, pruners.py:298). LLaMA-7B needs it: 128 windows of
2048 tokens in one forward hold two float32 copies of the ``down_proj`` input
alone, 11.5 GB each.

``collect="hessian_bf16"`` (SparseGPT only; engine.py:110-124, 666-690)
sums each X^T X over the chunks in float32 as ``"hessian"`` does and rounds
the finished sum once to bf16; the sweep widens it back to float32.

SparseGPT sweeps a block's same-shape linears together
(``sparsegpt_prune_weight_group``; T5's q/k/v/o and wi_0/wi_1) unless
``sparsegpt_group=False``, the JAX package's ``ECOFLAP_SPARSEGPT_GROUP=0``.

Under a mesh (``parallel.mesh.use_mesh``) each dp rank streams its slice
of the batch and the raw sums are all-reduced over dp once per block,
before any mask is chosen; every tp rank then reads the whole weight
through ``parallel.sharding.full_weight``, computes the same mask or sweep
from the same sums, and keeps its slice (``set_full_weight``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from ecoflap_tpu_torch.parallel.mesh import dp_size, dp_slice, dp_split, dp_sum_
from ecoflap_tpu_torch.parallel.sharding import full_shape, full_weight, set_full_weight
from ecoflap_tpu_torch.pruning.adapter import StackSpec
from ecoflap_tpu_torch.pruning.mezo import slice_microbatch
from ecoflap_tpu_torch.pruning.plans import leading_dim
from ecoflap_tpu_torch.pruning.sparsegpt import (
    sparsegpt_prune_weight,
    sparsegpt_prune_weight_group,
)
from ecoflap_tpu_torch.pruning.wanda import (
    apply_mask,
    mask_n_m,
    mask_per_row,
    mask_per_tensor,
    wanda_metric,
)
from ecoflap_tpu_torch.utils.profiling import span

LOCAL_METHODS = ("wanda", "sparsegpt")


def make_wanda_prune_fn(per_row_mask: bool, prune_n: int = 0,
                        prune_m: int = 0) -> Callable:
    """(w, col_sq_sum, n_seq, ratio) -> boolean prune mask: the Wanda metric
    and the reference's n:m, per-row or per-tensor selection."""

    def prune_mask(w, col_sq_sum, n_seq, ratio):
        metric = wanda_metric(w, col_sq_sum.to(torch.float32) / n_seq)
        if prune_n != 0:
            return mask_n_m(metric, prune_n, prune_m)
        return (mask_per_row if per_row_mask else mask_per_tensor)(metric, ratio)

    return prune_mask


def make_sparsegpt_prune_fns(blocksize: int = 128, percdamp: float = 0.01,
                             prune_n: int = 0, prune_m: int = 0):
    """(serial, grouped) OBS sweeps from raw X^T X sums: the serial one maps
    (w, xtx, n_seq, ratio) to the pruned weight, the grouped one (K, out,
    in) weights and (K, in, in) sums with K ratios to K pruned weights. The
    Hessian is (2 / n_seq) X^T X in float32 (SparseGPT.add_batch)."""

    def prune_weight(w, xtx, n_seq, ratio):
        h = (2.0 / n_seq) * xtx.to(torch.float32)
        return sparsegpt_prune_weight(w, h, ratio, blocksize=blocksize,
                                      percdamp=percdamp, prune_n=prune_n,
                                      prune_m=prune_m)

    def prune_weight_group(ws, xtxs, n_seq, ratios):
        hs = (2.0 / n_seq) * xtxs.to(torch.float32)
        return sparsegpt_prune_weight_group(ws, hs, ratios, blocksize=blocksize,
                                            percdamp=percdamp, prune_n=prune_n,
                                            prune_m=prune_m)

    return prune_weight, prune_weight_group


def shape_groups(block: nn.Module, linear_names) -> List[List[str]]:
    """The block's linears grouped by (whole) weight shape over distinct
    weights, in first-seen order (engine.py:282-296)."""
    groups: Dict[Any, List[str]] = {}
    seen = set()
    for local in linear_names:
        lin = block.get_submodule(local)
        if id(lin.weight) in seen:
            continue
        seen.add(id(lin.weight))
        groups.setdefault(full_shape(lin), []).append(local)
    return list(groups.values())


@torch.no_grad()
def stream_prune_stack(
    stack: StackSpec,
    model: nn.Module,
    batch: Any,
    sparsity_ratio: Mapping[str, float],
    verbose: bool = True,
    num_chunks: int = 1,
    method: str = "wanda",
    prune_n: int = 0,
    prune_m: int = 0,
    sparsegpt_group: bool = True,
    collect: Optional[str] = None,
) -> nn.Module:
    """Prune one stack of ``model`` in place with the local ``method``
    (``"wanda"`` or ``"sparsegpt"``), ``num_chunks`` forwards per pass (the
    count must divide the batch). ``prune_n``:``prune_m`` > 0 selects n:m
    masks. ``collect`` is the statistic: ``"wanda"`` (Wanda's default),
    ``"hessian"`` (SparseGPT's) or ``"hessian_bf16"``. Each block's
    statistics passes, pruning and re-forwards are spans
    (``ecoflap.fine.collect``, ``.prune``, ``.reforward``, tagged with the
    stack; ``utils/profiling.py``)."""
    if method not in LOCAL_METHODS:
        raise ValueError(f"unknown local method {method!r}")
    sparsegpt = method == "sparsegpt"
    collect = collect or ("hessian" if sparsegpt else "wanda")
    if collect not in (("hessian", "hessian_bf16") if sparsegpt else ("wanda",)):
        raise ValueError(f"collect={collect!r} does not serve method {method!r}")
    out_bf16 = collect == "hessian_bf16"
    if out_bf16:
        collect = "hessian"
    if sparsegpt:
        prune_weight, prune_group = make_sparsegpt_prune_fns(
            prune_n=prune_n, prune_m=prune_m)
    else:
        prune_mask = make_wanda_prune_fn(stack.per_row_mask, prune_n, prune_m)
    t0 = time.time()
    total = leading_dim(batch)
    split = dp_split(total)  # this rank streams its dp slice
    if split:
        batch = dp_slice(batch, total)
        num_chunks = math.gcd(num_chunks, total // dp_size())
    x, cache = stack.prepare_inputs(model, batch)
    # a private contiguous copy: the passes below overwrite it slice by slice
    x = x.clone(memory_format=torch.contiguous_format)
    n = x.shape[0]
    n_seq = float(n * dp_size() if split else n)
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
        with span("ecoflap.fine.collect", stack=stack.name):
            stats = {}
            for xc, cc in slices:
                _, part = stack.block_forward(block, xc, cc, collect)
                stats = {k: stats[k] + v if k in stats else v for k, v in part.items()}
            if split:  # linears that read one input share one tensor: reduce it once
                for v in {id(v): v for v in stats.values()}.values():
                    dp_sum_(v)
            if out_bf16:
                stats = {k: v.to(torch.bfloat16) for k, v in stats.items()}

        def ratio(local):
            return float(sparsity_ratio[stack.weight_key(i, local)])

        with span("ecoflap.fine.prune", stack=stack.name):
            if not sparsegpt:
                for local in stack.linears(i):
                    lin = block.get_submodule(local)
                    w = full_weight(lin)
                    apply_mask(w, prune_mask(w, stats[local], n_seq, ratio(local)))
                    set_full_weight(lin, w)
            else:
                groups = (shape_groups(block, stack.linears(i)) if sparsegpt_group
                          else [[local] for local in stack.linears(i)])
                for group in groups:
                    lins = [block.get_submodule(local) for local in group]
                    ws = [full_weight(lin) for lin in lins]
                    if len(group) >= 2:
                        new = prune_group(
                            torch.stack(ws), torch.stack([stats[ln] for ln in group]),
                            n_seq, [ratio(ln) for ln in group])
                    else:
                        new = prune_weight(ws[0], stats[group[0]], n_seq,
                                           ratio(group[0]))[None]
                    for lin, w2 in zip(lins, new):
                        set_full_weight(lin, w2)
            del stats
        with span("ecoflap.fine.reforward", stack=stack.name):
            for xc, cc in slices:
                xc.copy_(stack.block_forward(block, xc, cc, None)[0])
    return model


@torch.no_grad()
def check_stack_sparsity(stack: StackSpec, model: nn.Module,
                         verbose: bool = True) -> float:
    """Zero fraction over a stack's prunable weights
    (T5LayerWandaPruner.check_sparsity, wanda_pruner.py:139-163), counted
    on the whole weights."""
    count = total = 0
    for i, block in enumerate(stack.blocks(model)):
        sub_count = sub_total = 0
        for local in stack.linears(i):
            w = full_weight(block.get_submodule(local))
            sub_count += int((w == 0).sum())
            sub_total += w.numel()
        if verbose:
            print(f"layer {i} sparsity {sub_count / sub_total:.6f}")
        count += sub_count
        total += sub_total
    return count / total
