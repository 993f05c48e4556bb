"""Exact rank selection on the float bits of nonnegative scores (port of
``_bits`` and ``kth_smallest_bits_global`` in
``ecoflap_tpu/pruning/select.py``).

Nonnegative float32 values are ordered as their int32 bit patterns, so the
k-th smallest of a union of tensors is found by a bisection over the 31
value bits, each step one count of ``bits <= mid`` per tensor. Selecting on
the bits, not on float values, keeps the JAX package's semantics: -0.0 counts
as +0.0 (``abs`` clears the sign bit), and a NaN, whose bits lie above every
finite value's, ranks last, so a strict ``bits > threshold`` keeps it where
a float ``v > thr`` would prune it. The union is never concatenated: at
BLIP-2 FlanT5-XL the 588 targets hold 3.70e9 scores, 14.8 GB in float32.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

INT32_MAX = 2 ** 31 - 1


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """The int32 view of ``abs(x)`` in float32. A float32 input with no sign
    bit set is viewed in place; anything else is copied once."""
    x = x.to(torch.float32)
    if torch.signbit(x).any():
        x = x.abs()
    return x.view(torch.int32)


def kth_smallest_bits(leaves: Iterable[torch.Tensor], k: int) -> int:
    """The 0-indexed rank-``k`` value, as int32 bits, over the union of
    ``leaves`` (nonnegative int32 keys): the smallest v with
    count(bits <= v) >= k + 1, the JAX package's 31-step bisection
    (select.py:65-93), with the counts in int64."""
    leaves: List[torch.Tensor] = list(leaves)
    total = sum(b.numel() for b in leaves)
    if not 0 <= k < total:
        raise ValueError(f"rank {k} outside a union of {total} values")
    lo, hi = 0, INT32_MAX
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        count = sum(torch.count_nonzero(b <= mid) for b in leaves)
        if int(count) >= k + 1:
            hi = mid
        else:
            lo = mid + 1
    return hi
