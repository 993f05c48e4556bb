"""First-order importance, the gradient variant of the ECoFLaP coarse
stage (port of ``first_order_group_sums`` and ``streamed_plan_grad_sums`` in
``ecoflap_tpu/pruning/first_order.py``; reference
``LayerSparsity.compute_importance_scores``,
layer_single_base_pruner.py:416-471).

Per calibration microbatch, the gradient of the microbatch's mean loss with
respect to each target weight is reduced at once to one float32 scalar per
target, and the scalars are averaged over the microbatches:

  GradOnly:       sum |g|
  GradMagAbs:     sum |W| |g|
  GradMagSquare:  sum W^2 g^2

which is the sum over the tensor of the reference's per-element importance
(its |g| or g^2 sums are per batch, so the outer mean commutes with the
inner sum).

One implementation, the JAX package's streamed per-block backward: for each
stack that has a suffix plan, per microbatch,

  1. forward the stack without grad, keeping every block's input;
  2. take the cotangent of the stack's output, d mean(finish_fn) / dy;
  3. for blocks L-1 .. 0, recompute the block with grad on its input and on
     its target weights only, and get (g_x, g_W...) from the VJP;
  4. reduce each g_W to its scalar on the device, into one float32
     accumulator per target, all read back once at the end.

So no gradient larger than one block's weights ever exists, and the memory
held is the L block inputs of one microbatch. The JAX package proves these
sums equal its partitioned ``jax.grad`` default (tests/test_scores.py). Targets
that no plan matches take one plain backward over the whole loss per
microbatch (the JAX ``rest`` path).

The same two gradient sources feed ``accumulate_gradients`` and
``first_order_importance`` (first_order.py:35-82, 404-429), which keep
per-element float32 statistics instead of scalars: the ``Real*`` score
methods and the global |W|.|G| pruner read them. The model is frozen (``build_model``):
each target weight takes ``requires_grad`` only for its own backward. Both
paths enable grad themselves, so they run under a caller's ``no_grad`` (the
CLI prunes under one).

Under a mesh each dp rank takes its slice of every microbatch; the
per-sample losses are gathered before the mean, so each rank's backward
gives its samples' share of the whole microbatch's gradient, and the
weight gradients are summed over dp. Under tp every statistic is taken on
the whole weight and the whole gradient (both gathered over tp); a
replicated parameter's gradient is already whole on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from ecoflap_tpu_torch.parallel.mesh import all_gather_cat, dp_gather, dp_slice, dp_split, dp_sum_
from ecoflap_tpu_torch.parallel.sharding import full_weight, shard_of
from ecoflap_tpu_torch.pruning.mezo import LossFn, slice_microbatch
from ecoflap_tpu_torch.pruning.plans import leading_dim
from ecoflap_tpu_torch.pruning.targets import WeightTarget

SCORE_COMPUTES = ("GradOnly", "GradMagAbs", "GradMagSquare")


def _scalar_stat(g: torch.Tensor, w: torch.Tensor, score_compute: str) -> torch.Tensor:
    """Per-tensor importance sum of one (gradient, weight) pair, a float32
    0-dim tensor on their device (first_order.py:85-95)."""
    g = g.to(torch.float32)
    square = score_compute == "GradMagSquare"
    g = g * g if square else g.abs()
    if score_compute == "GradOnly":
        return g.sum()
    w = w.to(torch.float32)
    w = w * w if square else w.abs()
    return (w * g).sum()


@contextlib.contextmanager
def _requiring_grad(tensors: Iterable[torch.Tensor]):
    """Turn ``requires_grad`` on for ``tensors`` and restore each flag after."""
    tensors = list(tensors)
    flags = [t.requires_grad for t in tensors]
    try:
        for t in tensors:
            t.requires_grad_(True)
        yield
    finally:
        for t, f in zip(tensors, flags):
            t.requires_grad_(f)


def _microbatch(data: Any, b: int, num: int, batch_size: int):
    """(this rank's slice of microbatch ``b``, the microbatch's size)."""
    size = batch_size // num
    return dp_slice(slice_microbatch(data, b, num, batch_size), size), size


def _whole(lin: nn.Module, g: torch.Tensor, size: int):
    """(whole weight, whole gradient of it): ``g``, this rank's share of the
    microbatch's gradient of this rank's slice, summed over dp (when the
    microbatch of ``size`` was cut) and gathered over tp."""
    if dp_split(size):
        g = dp_sum_(g.contiguous())
    sh = shard_of(lin)
    if sh is not None:
        g = all_gather_cat(g, sh.dim, sh.group, sh.size)
    return full_weight(lin), g


@torch.enable_grad()
def _streamed_block_grads(model: nn.Module, data: Any, num_microbatches: int,
                          plan: Any):
    """Per microbatch, and per block from the last to the first, (block
    index, the block's target weights and their gradients of the
    microbatch's mean loss, both whole) through the per-block VJP of
    ``plan``'s stack (its ``stack``, ``finish_fn``, ``base_data`` and
    ``batch_size`` are read, its MeZO cache is not built). The gradients
    live until the next item."""
    stack = plan.stack
    blocks = stack.blocks(model)
    batch_size = leading_dim(data)
    for b in range(num_microbatches):
        mb, size = _microbatch(data, b, num_microbatches, batch_size)
        d, _ = _microbatch(plan.base_data, b, num_microbatches, plan.batch_size)
        with torch.no_grad():
            x, cache = stack.prepare_inputs(model, mb)
            xs: List[Optional[torch.Tensor]] = []
            for blk in blocks:
                xs.append(x)
                x, _ = stack.block_forward(blk, x, cache, None)
        y = x.requires_grad_(True)
        (g,) = torch.autograd.grad(dp_gather(plan.finish_fn(model, y, d), size).mean(), y)
        del y, x
        for i in range(stack.num_blocks - 1, -1, -1):
            lins = [blocks[i].get_submodule(ln) for ln in stack.linears(i)]
            ws = [lin.weight for lin in lins]
            x_in = xs[i]
            xs[i] = None
            if i > 0:  # block 0's input takes no gradient
                x_in.requires_grad_(True)
            with _requiring_grad(ws):
                out, _ = stack.block_forward(blocks[i], x_in, cache, None)
                grads = torch.autograd.grad(
                    out, ws + ([x_in] if i > 0 else []), grad_outputs=g.to(out.dtype))
            del out, x_in
            yield i, *zip(*[_whole(lin, gw, size) for lin, gw in zip(lins, grads)])
            g = grads[-1] if i > 0 else None
            del grads


@torch.enable_grad()
def _rest_grads(loss_fn: LossFn, model: nn.Module, data: Any,
                num_microbatches: int, targets: Sequence[WeightTarget]):
    """Targets outside every plan: per microbatch, (their whole weights,
    their whole gradients) from one backward of the whole mean loss, with
    grad on those weights only."""
    lins = [t.linear(model) for t in targets]
    ws = [lin.weight for lin in lins]
    batch_size = leading_dim(data)
    for b in range(num_microbatches):
        mb, size = _microbatch(data, b, num_microbatches, batch_size)
        with _requiring_grad(ws):
            grads = torch.autograd.grad(dp_gather(loss_fn(model, mb), size).mean(), ws)
        yield zip(*[_whole(lin, g, size) for lin, g in zip(lins, grads)])


def _target_grads(loss_fn: LossFn, model: nn.Module, data: Any,
                  num_microbatches: int, targets: Sequence[WeightTarget],
                  plans: Optional[Sequence[Any]]):
    """(target name, weight, gradient of the microbatch's mean loss) for
    every target and microbatch: each stack that a plan matches through
    its per-block VJP, the other targets through whole-loss backwards. Per
    target, the microbatches come in order."""
    wanted = {t.name for t in targets}
    rest = list(targets)
    for plan in plans or ():
        # a LossPlan has no stack to stream (first_order.py:263-266)
        if getattr(plan, "stack", None) is None or not any(
                plan.match(t.name) for t in rest):
            continue
        stack = plan.stack
        for i, ws, grads in _streamed_block_grads(model, data, num_microbatches, plan):
            for local, w, g in zip(stack.linears(i), ws, grads):
                name = stack.weight_key(i, local)
                if name in wanted:
                    yield name, w, g
        rest = [t for t in rest if not plan.match(t.name)]
    if rest:
        for ws, grads in _rest_grads(loss_fn, model, data, num_microbatches, rest):
            for t, w, g in zip(rest, ws, grads):
                yield t.name, w, g


def first_order_group_sums(
    loss_fn: LossFn,
    model: nn.Module,
    data: Any,
    num_microbatches: int,
    targets: List[WeightTarget],
    score_compute: str = "GradMagAbs",
    plans: Optional[Sequence[Any]] = None,
) -> Dict[str, float]:
    """Per-target importance sums, averaged over the microbatches
    (first_order.py:206-401) -- all the coarse-stage allocator needs.

    Args:
      loss_fn: (model, batch) -> (B,) per-sample losses, for targets no
        plan matches.
      data: the stacked coarse batch, leading dim = microbatches * bs.
      targets: the weights to score.
      score_compute: GradOnly, GradMagAbs or GradMagSquare.
      plans: suffix plans; each stack with a plan that matches a target
        takes the streamed per-block backward.
    Returns {target name: sum}.
    """
    if score_compute not in SCORE_COMPUTES:
        raise ValueError(f"unknown first-order score method {score_compute!r}; "
                         f"expected one of {SCORE_COMPUTES}")
    if num_microbatches < 1:
        raise ValueError("no calibration microbatches")
    acc: Dict[str, torch.Tensor] = {}  # float32 scalars on the device
    for name, w, g in _target_grads(loss_fn, model, data, num_microbatches, targets,
                                    plans):
        stat = _scalar_stat(g, w, score_compute)
        acc[name] = acc[name] + stat if name in acc else stat
    host = torch.stack([acc[t.name] for t in targets]).cpu().tolist()  # one readback
    return {t.name: v / num_microbatches for t, v in zip(targets, host)}


def accumulate_gradients(
    loss_fn: LossFn,
    model: nn.Module,
    data: Any,
    num_microbatches: int,
    targets: List[WeightTarget],
    square: bool = False,
    plans: Optional[Sequence[Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Per-target gradient statistics (first_order.py:35-82): the sum over
    microbatches of |g| (or g^2 when ``square``), g the gradient of the
    microbatch's mean loss, divided by the microbatch count; float32 tensors
    of the weights' shapes on their device. ``plans`` route their stacks
    through the per-block VJP, as in ``first_order_group_sums``, so no
    gradient larger than one block's weights exists beside the float32
    accumulators."""
    if num_microbatches < 1:
        raise ValueError("no calibration microbatches")
    acc: Dict[str, torch.Tensor] = {}
    for name, _, g in _target_grads(loss_fn, model, data, num_microbatches, targets,
                                    plans):
        g = g.to(torch.float32)
        g = g * g if square else g.abs()
        if name in acc:
            acc[name].add_(g)
        else:
            acc[name] = g
    return {t.name: acc[t.name].div_(num_microbatches) for t in targets}


def first_order_importance(
    loss_fn: LossFn,
    model: nn.Module,
    data: Any,
    num_microbatches: int,
    targets: List[WeightTarget],
    score_compute: str = "GradMagAbs",
    plans: Optional[Sequence[Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Per-target, per-element importance (first_order.py:404-429), float32:
    |W| |G| (GradMagAbs), W^2 G (GradMagSquare) or |G| (GradOnly), with G
    from ``accumulate_gradients`` (|g| sums, or g^2 sums for
    GradMagSquare). Each importance is built in its accumulator's storage."""
    if score_compute not in SCORE_COMPUTES:
        raise ValueError(f"unknown first-order score method {score_compute!r}; "
                         f"expected one of {SCORE_COMPUTES}")
    square = score_compute == "GradMagSquare"
    grads = accumulate_gradients(loss_fn, model, data, num_microbatches, targets,
                                 square=square, plans=plans)
    if score_compute != "GradOnly":  # G is already nonnegative
        for t in targets:
            w = t.full_weight(model).to(torch.float32)
            grads[t.name].mul_(w * w if square else w.abs())
    return grads
