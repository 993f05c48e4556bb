"""Wanda metric and masks (port of ``ecoflap_tpu/pruning/wanda.py`` with the
semantics of ``pruning/select.py``; reference wanda_pruner.py).

* metric ``|W| * sqrt(scaler_row)`` in float32 (wanda_pruner.py:260);
* T5 per-row mask: the ``floor(cols * ratio)`` smallest of each row, ties
  broken by position (``torch.sort(stable=True)``, wanda_pruner.py:272-277);
* ViT per-tensor mask: ``metric <= sorted[clip(floor(n * ratio), 0, n-1)]``
  (wanda_pruner.py:553-556): ties at the threshold are all pruned, so it
  prunes at least the requested share;
* n:m mask (``--sparsity_type n:m``): the ``n`` smallest of each row's
  consecutive groups of ``m`` input columns, ties by position
  (wanda_pruner.py:265-270).

Masks are boolean, True = prune. ``floor(n * ratio)`` is taken in float32,
as jnp does with a float32 ratio. The JAX package's bit bisection exists
only because sorts are slow on a TPU and has no counterpart here.
"""

from __future__ import annotations

import torch


def wanda_metric(w: torch.Tensor, scaler_row: torch.Tensor) -> torch.Tensor:
    """w: (out, in); scaler_row: (in,) per-column mean of x^2."""
    return w.to(torch.float32).abs() * torch.sqrt(scaler_row.to(torch.float32))[None, :]


def floor_count(n: int, ratio: float) -> int:
    return int(torch.floor(torch.tensor(ratio, dtype=torch.float32) * n))


def mask_per_row(metric: torch.Tensor, ratio: float) -> torch.Tensor:
    k = floor_count(metric.shape[-1], ratio)
    mask = torch.zeros(metric.shape, dtype=torch.bool, device=metric.device)
    if k > 0:
        order = torch.sort(metric, dim=-1, stable=True).indices
        mask.scatter_(-1, order[..., :k], True)
    return mask


def mask_per_tensor(metric: torch.Tensor, ratio: float) -> torch.Tensor:
    n = metric.numel()
    idx = min(max(floor_count(n, ratio), 0), n - 1)
    thres = torch.sort(metric.reshape(-1)).values[idx]
    return metric <= thres


def mask_n_m(metric: torch.Tensor, prune_n: int, prune_m: int) -> torch.Tensor:
    rows, cols = metric.shape
    if cols % prune_m:
        raise ValueError(f"cols {cols} not divisible by m={prune_m}")
    grouped = metric.reshape(rows, cols // prune_m, prune_m)
    order = torch.sort(grouped, dim=-1, stable=True).indices
    mask = torch.zeros(grouped.shape, dtype=torch.bool, device=metric.device)
    return mask.scatter_(-1, order[..., :prune_n], True).reshape(rows, cols)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the masked weights in place."""
    return w.masked_fill_(mask, 0)
