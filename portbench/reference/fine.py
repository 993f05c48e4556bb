"""Plain fine stage of ECoFLaP: Wanda (LAVIS wanda_pruner.py) and SparseGPT
(sparsegpt_pruner.py), one stack at a time, block by block.

For each block: run the calibration batch through it, microbatch by
microbatch, folding each linear's input statistic; prune every linear to its
ratio; run the block again with the pruned weights to give the next block
its inputs, so a block calibrates against the pruned blocks before it.

Wanda's metric is |W| sqrt(sum x^2 / n) with n the number of calibration
samples; T5 prunes the floor(cols r) smallest of each row (ties by
position), the ViT every entry at or under the floor(n r)-th smallest of the
tensor. SparseGPT sweeps the columns in blocks of 128 with H = (2/n) X^T X,
1% damping and the per-block saliency W^2 / diag(Hinv)^2.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple

import torch


def floor_count(n: int, ratio: float) -> int:
    return int(torch.floor(torch.tensor(ratio, dtype=torch.float32) * n))


def wanda_mask(w: torch.Tensor, col_sq_sum: torch.Tensor, n: float, ratio: float,
               per_row: bool) -> torch.Tensor:
    """True = prune."""
    metric = w.to(torch.float32).abs() * torch.sqrt(col_sq_sum / n)[None, :]
    if per_row:
        k = floor_count(metric.shape[-1], ratio)
        mask = torch.zeros(metric.shape, dtype=torch.bool, device=metric.device)
        if k > 0:
            mask.scatter_(-1, torch.sort(metric, dim=-1, stable=True).indices[:, :k], True)
        return mask
    idx = min(max(floor_count(metric.numel(), ratio), 0), metric.numel() - 1)
    return metric <= torch.sort(metric.reshape(-1)).values[idx]


def _cholesky(h: torch.Tensor, damp: torch.Tensor, tries: int = 50) -> torch.Tensor:
    """Lower factor of the symmetric part of h; on failure the diagonal
    takes ``damp`` once more, cumulatively (sparsegpt_pruner.py:117-131)."""
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    for _ in range(tries + 1):
        chol, info = torch.linalg.cholesky_ex((h + h.T) / 2)
        if int(info) == 0 and not bool(torch.isnan(chol).any()):
            return chol
        h = h + damp * eye
    raise RuntimeError("Cholesky failed after damping")


def sparsegpt_prune(w: torch.Tensor, xtx: torch.Tensor, n: float, ratio: float,
                    blocksize: int = 128, percdamp: float = 0.01) -> torch.Tensor:
    """The OBS sweep of one (out, in) weight in float32; returns the pruned
    weight in w's dtype."""
    h = (2.0 / n) * xtx.to(torch.float32)
    wf = w.to(torch.float32).clone()
    d = torch.diagonal(h)
    dead = d == 0
    h[dead, dead] = 1.0
    wf[:, dead] = 0.0
    hinv = torch.cholesky_inverse(_cholesky(h, percdamp * torch.diagonal(h).mean()))
    hinv = _cholesky(hinv, percdamp * torch.diagonal(hinv).abs().mean()).T
    cols = wf.shape[1]
    for i1 in range(0, cols, blocksize):
        i2 = min(i1 + blocksize, cols)
        w1 = wf[:, i1:i2].clone()
        hinv1 = hinv[i1:i2, i1:i2]
        dg = torch.diagonal(hinv1)
        sal = w1 ** 2 / dg[None, :] ** 2
        k = min(max(floor_count(sal.numel(), ratio), 0), sal.numel() - 1)
        mask1 = sal <= torch.sort(sal.reshape(-1)).values[k]
        q1 = torch.zeros_like(w1)
        err1 = torch.zeros_like(w1)
        for i in range(i2 - i1):
            col = w1[:, i]
            q = col.masked_fill(mask1[:, i], 0.0)
            err = (col - q) / dg[i]
            w1[:, i:] -= err[:, None] * hinv1[i, i:][None, :]
            q1[:, i] = q
            err1[:, i] = err
        wf[:, i1:i2] = q1
        if i2 < cols:
            wf[:, i2:] -= err1 @ hinv[i1:i2, i2:]
    return wf.to(w.dtype)


def objective(w: torch.Tensor, pruned: torch.Tensor, xtx: torch.Tensor) -> float:
    """SparseGPT's layer loss ||W X^T - W' X^T||^2 = tr((W - W') X^T X (W - W')^T)."""
    d = w.to(torch.float32) - pruned.to(torch.float32)
    return float(((d @ xtx.to(torch.float32)) * d).sum())


def prune_stack(weights: Dict[str, torch.Tensor], names: Callable[[int], List[str]],
                num_blocks: int, block_fn: Callable, inputs: List, ratios: Mapping[str, float],
                method: str, per_row: bool, n: float,
                follow: Optional[Mapping[str, torch.Tensor]] = None,
                blocks: Optional[Set[int]] = None,
                losses: Optional[Dict[str, Tuple[float, float]]] = None
                ) -> Dict[str, torch.Tensor]:
    """Prune one stack block by block; returns {weight key: pruned weight}.

    ``names(i)`` gives (local name, weight key) pairs of block i;
    ``block_fn(i, x, cache, stats, mode)`` runs block i with ``weights``;
    ``inputs`` is a list of (x, cache) per microbatch, overwritten with each
    block's pruned outputs. ``n`` is the number of calibration samples.
    ``weights`` takes each block's pruned weights before the block runs
    again to give the next block its inputs: this function's own, or, with
    ``follow``, those that ``follow`` holds (a judged run's), so that each
    block is pruned from the state the judged run reached. With ``follow``,
    ``blocks`` limits the pruning to those blocks (the others only run), and
    ``losses`` receives, per pruned weight, SparseGPT's layer loss of the
    judged run's weight and of this function's."""
    mode = "wanda" if method == "wanda" else "hessian"
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_blocks):
        mine = follow is None or blocks is None or i in blocks
        stats: Dict[str, torch.Tensor] = {}
        if mine:
            for x, cache in inputs:
                block_fn(i, x, cache, stats, mode)
        for local, key in names(i):
            w = weights[key]
            if mine and method == "wanda":
                out[key] = w.masked_fill(wanda_mask(w, stats[local], n, ratios[key], per_row), 0)
            elif mine:
                out[key] = sparsegpt_prune(w, stats[local], n, ratios[key])
                if losses is not None and follow is not None:
                    losses[key] = (objective(w, follow[key], stats[local]),
                                   objective(w, out[key], stats[local]))
            weights[key] = out[key] if follow is None else follow[key]
        del stats
        for j, (x, cache) in enumerate(inputs):
            inputs[j] = (block_fn(i, x, cache, None, None), cache)
    return out
