"""Plain ECoFLaP sparsity allocation: per-group scores -> per-group ratios
under one global keep budget (LAVIS ``LayerSparsity.compute_the_sparsity_
per_group``, layer_single_base_pruner.py:247-314, with its overshoot fix-up
subtracting, so that the kept total meets the budget exactly).

Each group first keeps ceil(n (1 - cap)); the rest of the budget goes out in
proportion to the scores, rounded up, saturated groups taking no more; then
a stuck remainder goes greedily to the groups with most headroom, and an
overshoot comes off the largest keeps, never below their floor.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def allocate(total_keep: int, group_scores: Mapping[str, float],
             group_params: Mapping[str, int], cap: float) -> Dict[str, float]:
    keys = list(group_scores)
    scores = np.asarray([float(group_scores[k]) for k in keys], dtype=np.float64)
    n = np.asarray([int(group_params[k]) for k in keys], dtype=np.int64)
    floors = np.ceil(n * (1.0 - cap)).astype(np.int64)
    budget = int(np.clip(total_keep, floors.sum(), n.sum()))
    keep = floors.copy()
    for _ in range(10_000):
        if keep.sum() >= budget:
            break
        total, rest = scores.sum(), budget - keep.sum()
        add = (np.ceil(scores / total * rest).astype(np.int64) if total > 0
               else np.zeros_like(keep))
        keep = keep + add
        scores[keep >= n] = 0
        keep = np.minimum(keep, n)
        if add.sum() == 0 and keep.sum() < budget:
            need = budget - keep.sum()
            room = n - keep
            for idx in np.argsort(-room, kind="stable"):
                if need <= 0:
                    break
                take = min(need, int(room[idx]))
                keep[idx] += take
                need -= take
        if keep.sum() > budget:
            over = int(keep.sum() - budget)
            for idx in np.argsort(-keep, kind="stable"):
                if over <= 0:
                    break
                cut = min(over, int(keep[idx] - floors[idx]))
                keep[idx] -= cut
                over -= cut
    return {k: float(s) for k, s in zip(keys, np.clip(1.0 - keep / n, 0.0, 1.0))}


def block_sparsity(scores: Mapping[str, float], numels: Mapping[str, int],
                   sparsity: float, cap: float) -> Dict[str, float]:
    """ECoFLaP at block granularity with ``_sum`` aggregation: a block's
    score is the sum of |score| over its weights (keys
    ``<stack>.<block>.<linear>.weight``), and every weight of a block gets
    the block's ratio."""
    group_of = {k: _block_group(k) for k in scores}
    gs: Dict[str, float] = {}
    gn: Dict[str, int] = {}
    for k, s in scores.items():
        g = group_of[k]
        gs[g] = gs.get(g, 0.0) + abs(float(s))
        gn[g] = gn.get(g, 0) + int(numels[k])
    ratios = allocate(int(sum(gn.values()) * (1.0 - sparsity)), gs, gn, cap)
    return {k: ratios[g] for k, g in group_of.items()}


def _block_group(key: str) -> str:
    """``visual_encoder.blocks.3.attn.qkv.weight`` -> ``visual_encoder.blocks.3``:
    the key up to and including its first all-digit part."""
    parts = key.split(".")
    i = next(j for j, part in enumerate(parts) if part.isdigit())
    return ".".join(parts[:i + 1])
