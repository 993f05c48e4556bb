"""Global and layerwise masks for the global-mask baselines (port of
``ecoflap_tpu/pruning/masks.py``; reference ``LayerSparsity.get_mask`` /
``get_layerwise_mask``, layer_single_base_pruner.py:156-197).

* global mask: per tensor, the top ``(1 - max_sparsity)`` share of scores
  is promoted to float32's largest value (a keep-floor); then one threshold
  at the p-th smallest score over all tensors, and a mask keeps the entries
  strictly above it.
* layerwise mask: one threshold per tensor, the same strict comparison.

Both select on the float bits (select.py), as the JAX package does. The
masks are ``bool`` (True = keep): at BLIP-2 FlanT5-XL they hold 3.7 GB
where float32 masks would hold 14.8 GB.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from ecoflap_tpu_torch.pruning.select import float_bits, kth_smallest_bits

# the int32 bits of float32's largest finite value
_FINFO_MAX_BITS = int(torch.tensor(torch.finfo(torch.float32).max).view(torch.int32))


def global_mask(importance: Mapping[str, torch.Tensor], p: float,
                max_sparsity_per_layer: float = 1.0) -> Dict[str, torch.Tensor]:
    """One global threshold over all tensors, with per-tensor keep-floors
    (masks.py:35-63)."""
    protected: Dict[str, torch.Tensor] = {}
    total = 0
    for k, v in importance.items():
        bits = float_bits(v)
        total += bits.numel()
        num_keep_floor = int(bits.numel() * (1.0 - max_sparsity_per_layer))
        if num_keep_floor > 0:
            # the num_keep_floor-th largest is ascending rank size - floor
            kth = kth_smallest_bits([bits], bits.numel() - num_keep_floor)
            bits = torch.where(bits >= kth, _FINFO_MAX_BITS, bits)
        protected[k] = bits
    num_zero = int(p * total)
    if num_zero <= 0:
        return {k: torch.ones_like(b, dtype=torch.bool) for k, b in protected.items()}
    threshold = kth_smallest_bits(protected.values(), num_zero - 1)
    return {k: b > threshold for k, b in protected.items()}


def layerwise_mask(importance: Mapping[str, torch.Tensor], p: float
                   ) -> Dict[str, torch.Tensor]:
    """A threshold per tensor at its p-th smallest score, keep strictly
    greater (masks.py:66-79)."""
    masks = {}
    for k, v in importance.items():
        bits = float_bits(v)
        num_zero = int(p * bits.numel())
        if num_zero <= 0:
            masks[k] = torch.ones_like(bits, dtype=torch.bool)
            continue
        masks[k] = bits > kth_smallest_bits([bits], num_zero - 1)
    return masks


def iterative_sparsity_schedule(target_sparsity: float, iterations: int) -> List[float]:
    """p_i = target ** (iterations / i), the reference's ramp
    (global_pruner.py:166, layer_single_base_pruner.py:213): 0.125, 0.354,
    0.5 for 3 iterations at 0.5."""
    return [target_sparsity ** (iterations / i) for i in range(1, iterations + 1)]
