"""Coarse stage: importance scores -> per-layer sparsity dict (port of
``compute_layer_sparsity`` in ``ecoflap_tpu/pruning/sparsity.py``, MeZO and
first-order methods; reference ``LayerSparsity``,
layer_single_base_pruner.py:120-561).

* empty group mapping -> ``UniformSparsity(original_sparsity)``
* ``MEZO-*`` methods -> zeroth-order scalar scores (mezo.py)
* ``Grad*`` methods (GradOnly, GradMagAbs, GradMagSquare) -> first-order
  importance sums (first_order.py); ``Real*`` methods are not ported
* per-group aggregation: the sum of importance, or the sum over the group's
  parameter count for the ``_avg`` suffix
* exact-budget water-filling with a per-group cap (allocator.py)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

from torch import nn

from ecoflap_tpu_torch.pruning.allocator import (
    UniformSparsity,
    compute_sparsity_per_group,
)
from ecoflap_tpu_torch.pruning.first_order import SCORE_COMPUTES, first_order_group_sums
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
    loss_plans: Optional[Sequence[Any]] = None,
    noise: Optional[NoiseFn] = None,
    leaf_scores_out: Optional[Dict[str, float]] = None,
    verbose: bool = True,
) -> SparsityDict:
    """Per-layer sparsity ratios under a global budget. ``loss_plans`` are
    the suffix plans: MeZO evaluates suffixes through them, first-order
    streams each planned stack's backward block by block.
    ``noise_mode`` and ``ensemble`` go to ``mezo_leaf_scores``.
    ``leaf_scores_out``, when given, receives the per-target scores: the
    MeZO scores, or the first-order importance sums."""
    if max_sparsity_per_layer < original_sparsity:
        raise ValueError("max_sparsity_per_layer must be >= the global target "
                         "sparsity (layer_single_base_pruner.py:154)")
    if not layer_to_group_mapping:
        return UniformSparsity(original_sparsity)

    score_compute, score_aggregate = score_method.split("_")
    if not (score_compute.startswith("MEZO") or score_compute in SCORE_COMPUTES):
        raise NotImplementedError(
            f"score method {score_method!r} is not ported yet (ROADMAP.md: "
            "Real* methods and the global pruners)")
    by_name = {t.name: t for t in targets}
    scored = [by_name[k] for k in layer_to_group_mapping if k in by_name]

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
    group_sparsity = compute_sparsity_per_group(
        total_to_keep, group_scores, group_num_parameters, max_sparsity_per_layer)

    if verbose:
        kept = sum((1.0 - group_sparsity[g]) * n
                   for g, n in group_num_parameters.items())
        print(kept, total_to_keep)  # budget sanity print (:402-407)
    return {k: group_sparsity[v] for k, v in layer_to_group_mapping.items()}
