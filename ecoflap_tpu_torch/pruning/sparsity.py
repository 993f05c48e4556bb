"""Coarse stage: importance scores -> per-layer sparsity dict (port of
``compute_layer_sparsity`` in ``ecoflap_tpu/pruning/sparsity.py``; reference
``LayerSparsity``, layer_single_base_pruner.py:120-561).

* empty group mapping -> ``UniformSparsity(original_sparsity)``
* ``Real*`` methods -> prune globally for 3 iterations by first-order
  importance and read each target's zero share (``_real_global_sparsity``)
* ``MEZO-*`` methods -> zeroth-order scalar scores (mezo.py)
* ``Grad*`` methods (GradOnly, GradMagAbs, GradMagSquare) -> first-order
  importance sums (first_order.py)
* per-group aggregation: the sum of importance, or the sum over the group's
  parameter count for the ``_avg`` suffix
* exact-budget water-filling with a per-group cap (allocator.py), over all
  groups or, with ``prune_per_model``, per submodel prefix
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from ecoflap_tpu_torch.pruning.allocator import (
    UniformSparsity,
    compute_sparsity_per_group,
)
from ecoflap_tpu_torch.pruning.first_order import (
    SCORE_COMPUTES,
    first_order_group_sums,
    first_order_importance,
)
from ecoflap_tpu_torch.pruning.masks import global_mask, iterative_sparsity_schedule
from ecoflap_tpu_torch.pruning.mezo import NoiseFn, mezo_group_sums, mezo_leaf_scores
from ecoflap_tpu_torch.pruning.targets import WeightTarget

SparsityDict = Union[Dict[str, float], UniformSparsity]


def compute_layer_sparsity(
    loss_fn: Callable,
    model: nn.Module,
    data: Any,
    num_microbatches: int,
    targets: List[WeightTarget],
    original_sparsity: float,
    layer_to_group_mapping: Optional[Mapping[str, str]],
    max_sparsity_per_layer: float = 0.8,
    score_method: str = "MEZO-GradOnly_sum",
    num_noise: int = 1,
    noise_eps: float = 1e-3,
    seed: int = 0,
    noise_mode: str = "per_batch",
    ensemble: Optional[bool] = None,
    prune_per_model: bool = False,
    per_model_group: Sequence[str] = (),
    loss_plans: Optional[Sequence[Any]] = None,
    noise: Optional[NoiseFn] = None,
    leaf_scores_out: Optional[Dict[str, float]] = None,
    verbose: bool = True,
) -> SparsityDict:
    """Per-layer sparsity ratios under a global budget. ``loss_plans`` are
    the suffix plans: MeZO evaluates suffixes through them, first-order
    streams each planned stack's backward block by block.
    ``noise_mode`` and ``ensemble`` go to ``mezo_leaf_scores``.
    ``prune_per_model`` splits the budget over the groups of each prefix of
    ``per_model_group``. ``leaf_scores_out``, when given, receives the per-target
    scores: the MeZO scores, or the first-order importance sums."""
    if max_sparsity_per_layer < original_sparsity:
        raise ValueError("max_sparsity_per_layer must be >= the global target "
                         "sparsity (layer_single_base_pruner.py:154)")
    if not layer_to_group_mapping:
        return UniformSparsity(original_sparsity)

    score_compute, score_aggregate = score_method.split("_")
    by_name = {t.name: t for t in targets}
    scored = [by_name[k] for k in layer_to_group_mapping if k in by_name]

    if score_compute.startswith("Real"):
        return _real_global_sparsity(
            loss_fn, model, data, num_microbatches, scored, original_sparsity,
            score_compute[len("Real"):].lstrip("-") or "GradMagAbs", loss_plans)
    if not (score_compute.startswith("MEZO") or score_compute in SCORE_COMPUTES):
        raise ValueError(f"unknown score method {score_method!r}")
    if score_compute.startswith("MEZO"):
        leaf_scores = mezo_leaf_scores(
            loss_fn, model, data, num_microbatches, scored, eps=noise_eps,
            num_noise=num_noise, seed=seed, noise_mode=noise_mode,
            loss_plans=loss_plans, noise=noise, ensemble=ensemble)
        importance = mezo_group_sums(model, scored, leaf_scores, score_compute)
    else:
        leaf_scores = importance = first_order_group_sums(
            loss_fn, model, data, num_microbatches, scored, score_compute,
            plans=loss_plans)
    if leaf_scores_out is not None:
        leaf_scores_out.update(leaf_scores)

    group_scores: Dict[str, float] = {}
    group_num_parameters: Dict[str, int] = {}
    for t in scored:
        g = layer_to_group_mapping[t.name]
        group_scores[g] = group_scores.get(g, 0.0) + float(importance[t.name])
        group_num_parameters[g] = group_num_parameters.get(g, 0) + t.numel(model)
    if score_aggregate == "avg":
        for g in group_scores:
            group_scores[g] /= group_num_parameters[g]

    total_parameters = sum(group_num_parameters.values())
    total_to_keep = int(total_parameters * (1.0 - original_sparsity))
    if prune_per_model:
        group_sparsity: Dict[str, float] = {}
        for prefix in per_model_group:
            sub_scores = {g: v for g, v in group_scores.items() if g.startswith(prefix)}
            sub_params = {g: n for g, n in group_num_parameters.items()
                          if g.startswith(prefix)}
            sub_keep = int(sum(sub_params.values()) * (1.0 - original_sparsity))
            group_sparsity.update(compute_sparsity_per_group(
                sub_keep, sub_scores, sub_params, max_sparsity_per_layer))
    else:
        group_sparsity = compute_sparsity_per_group(
            total_to_keep, group_scores, group_num_parameters, max_sparsity_per_layer)

    if verbose:
        kept = sum((1.0 - group_sparsity[g]) * n
                   for g, n in group_num_parameters.items())
        print(kept, total_to_keep)  # budget sanity print (:402-407)
    return {k: group_sparsity[v] for k, v in layer_to_group_mapping.items()}


@torch.no_grad()
def _real_global_sparsity(
    loss_fn: Callable,
    model: nn.Module,
    data: Any,
    num_microbatches: int,
    targets: List[WeightTarget],
    target_sparsity: float,
    score_compute: str,
    loss_plans: Optional[Sequence[Any]] = None,
    iterations: int = 3,
) -> Dict[str, float]:
    """``Real*`` methods (sparsity.py:204-236; global_iterative_pruning,
    layer_single_base_pruner.py:199-245): prune the targets globally by
    first-order importance for ``iterations`` rounds of the schedule, each
    round scoring the weights the last one left, and return each target's
    zero share. The JAX package prunes a functional copy; here the model's
    weights are pruned in place and restored bit for bit afterwards."""
    weights = [t.weight(model) for t in targets]  # this rank's slices under tp
    saved = [w.clone() for w in weights]
    try:
        masks: Optional[Dict[str, torch.Tensor]] = None
        for p_i in iterative_sparsity_schedule(target_sparsity, iterations):
            imp = first_order_importance(loss_fn, model, data, num_microbatches,
                                         targets, score_compute, plans=loss_plans)
            if masks is not None:
                for k, v in imp.items():
                    v.mul_(masks[k])
            masks = global_mask(imp, p_i, max_sparsity_per_layer=1.0)
            del imp
            for t, w in zip(targets, weights):
                w.mul_(t.local_slice(model, masks[t.name]))
        return {t.name: float((t.full_weight(model) == 0).float().mean())
                for t in targets}
    finally:
        for w, w0 in zip(weights, saved):
            w.copy_(w0)
