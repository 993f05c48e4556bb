"""SparseGPT local pruning: the Hessian-inverse OBS column sweep (port of
``ecoflap_tpu/pruning/sparsegpt.py``; reference ``SparseGPT.add_batch`` and
``fasterprune``, sparsegpt_pruner.py:71-218).

* ``H = (2/n) sum X^T X`` over the calibration sequences (``accumulate_hessian``;
  the fine stage builds it from the raw float32 sum, engine.py);
* dead input columns (diag 0) get a unit diagonal and a zero weight column;
* +-inf entries are clamped to the 0.999 / 0.001 quantiles;
* a Cholesky with cumulative diagonal damping on failure, starting from the
  undamped matrix, up to 50 tries (``torch.linalg.cholesky_ex`` and its
  ``info``; a factor that still fails is NaN, as XLA's is);
* ``Hinv`` = the upper Cholesky factor of ``(L L^T)^-1``;
* per 128-column block: the saliency ``W^2 / diag(Hinv)^2`` thresholded per
  block (``sal <= sorted[clip(floor(n sp), 0, n-1)]``, Wanda's per-tensor
  rule) or an n:m mask refreshed per m-group, then the sequential sweep
  ``W1[:, i:] -= err (x) Hinv1[i, i:]`` and the cross-block update
  ``W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]``.

NaN safety, as in the JAX package: both updates write only the columns at or
after the current one (slices, where the JAX package masks a full-width
product's output), so a non-finite ``Hinv`` entry never reaches a finished
column. ``sparsegpt_prune_weight_group`` sweeps K same-shape weights in one
batched pass (``torch.bmm``): lanes never mix, so a lane whose Hessian fails
leaves the others exact.

On the card the in-block sweep is one launch of a hand-written CUDA kernel
per column block (``ops/sparsegpt_sweep.py``, ``csrc/sparsegpt_sweep.cu``):
every row runs its 128-step chain in registers, writes Q1 over the block's
columns of the weight in place and Err1 to a buffer, n:m masks included;
``_sweep_block`` is its plain version, which a CPU tensor takes and which
gives the kernel's bits on the card. The cross-block update stays one
``torch.bmm``. Each call's ``prepare_hinv`` and column sweep are spans
(``ecoflap.fine.prepare_hinv``, ``ecoflap.fine.sweep``), and each kernel
launch is counted (``ecoflap.fine.sweep_kernel``; ``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ecoflap_tpu_torch.ops.sparsegpt_sweep import sparsegpt_sweep
from ecoflap_tpu_torch.pruning.wanda import floor_count
from ecoflap_tpu_torch.utils.profiling import count, span


def accumulate_hessian(h: torch.Tensor, nsamples: float,
                       x: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """Fold one calibration batch ``x`` (batch, ..., in) into the running
    (in, in) float32 Hessian (SparseGPT.add_batch, sparsegpt_pruner.py:71-82).
    Returns (h, nsamples)."""
    tmp = x.shape[0]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    new_n = nsamples + tmp
    h = h * (nsamples / new_n)
    return h + (2.0 / new_n) * (x2.T @ x2), new_n


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.quantile's linear method on a flat float32 tensor: NaN if any
    entry is NaN, else the sorted values at floor / ceil of q (n - 1),
    weighted by the fraction (torch.quantile refuses large inputs)."""
    n = flat.numel()
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    frac = (pos - lo).to(flat.device)
    s = torch.sort(flat).values
    out = s[lo] * (1 - frac) + s[hi] * frac
    return torch.where(torch.isnan(flat).any(), torch.nan, out)


def _clamp_infs(h: torch.Tensor) -> torch.Tensor:
    """+inf -> the 0.999 quantile, -inf -> the 0.001 quantile
    (sparsegpt_pruner.py:104-112, 136-144); the sorts only run when the
    matrix holds an inf."""
    if not bool(torch.isinf(h).any()):
        return h
    flat = h.reshape(-1)
    hi, lo = _quantile(flat, 0.999), _quantile(flat, 0.001)
    h = torch.where(torch.isposinf(h), hi, h)
    return torch.where(torch.isneginf(h), lo, h)


def robust_cholesky(h: torch.Tensor, damp: torch.Tensor,
                    max_tries: int = 50) -> torch.Tensor:
    """Lower Cholesky factor of each (.., n, n) matrix; a lane that fails
    (``info`` > 0, or NaN in its factor) gets ``damp`` added to its diagonal
    once more and is factored again, cumulatively, up to ``max_tries``
    times (sparsegpt_pruner.py:117-131). A lane that never succeeds is NaN.
    ``damp`` is a scalar per lane."""
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    damp = damp.reshape(*damp.shape, 1, 1)

    def factor(m):
        # the symmetric part, as jnp.linalg.cholesky factors it (LAPACK
        # would read the lower triangle only)
        chol, info = torch.linalg.cholesky_ex((m + m.mT) / 2)
        bad = (info != 0) | torch.isnan(chol).flatten(-2).any(-1)
        return chol, bad

    chol, bad = factor(h)
    tries = 0
    while bool(bad.any()) and tries < max_tries:
        h = torch.where(bad[..., None, None], h + damp * eye, h)
        again, bad_again = factor(h)
        chol = torch.where(bad[..., None, None], again, chol)
        bad = bad & bad_again
        tries += 1
    return torch.where(bad[..., None, None], torch.nan, chol)


def prepare_hinv(h: torch.Tensor, percdamp: float = 0.01
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H (.., n, n) -> (upper Cholesky factor U of H^-1, with H^-1 = U^T U;
    dead-column mask (.., n)), in float32 (float64 for a float64 ``h``).
    Batched over leading dimensions; the inf clamp and the damping run per
    lane."""
    h = h.to(torch.promote_types(h.dtype, torch.float32)).clone()
    d = torch.diagonal(h, dim1=-2, dim2=-1)
    dead = d == 0
    d.masked_fill_(dead, 1.0)
    lanes = h.reshape(-1, *h.shape[-2:])
    h = torch.stack([_clamp_infs(m) for m in lanes]).reshape(h.shape)
    damp = percdamp * torch.diagonal(h, dim1=-2, dim2=-1).mean(-1)
    # (L L^T)^-1 from the lower factor (the JAX package's _cholesky_inverse)
    hinv = torch.cholesky_inverse(robust_cholesky(h, damp))
    hinv = torch.stack([_clamp_infs(m) for m in hinv.reshape(lanes.shape)]
                       ).reshape(h.shape)
    damp2 = percdamp * torch.diagonal(hinv, dim1=-2, dim2=-1).abs().mean(-1)
    return robust_cholesky(hinv, damp2).transpose(-1, -2), dead


def _mask_per_tensor(sal: torch.Tensor, sparsity: float) -> torch.Tensor:
    """``sal <= sorted[clip(floor(n sp), 0, n-1)]`` (sparsegpt_pruner.py:172),
    with the JAX package's order for NaN (it compares float bits,
    select.py): NaN sorts above +inf, and a NaN threshold prunes every
    entry, so a lane whose Hessian failed comes out zero."""
    n = sal.numel()
    idx = min(max(floor_count(n, sparsity), 0), n - 1)
    thres = torch.sort(sal.reshape(-1)).values[idx]
    return (sal <= thres) | torch.isnan(thres)


def _nm_mask(sal: torch.Tensor, prune_n: int) -> torch.Tensor:
    """True for the ``prune_n`` smallest of each row of (.., rows, m), ties
    by position (a stable sort, as the reference's ``torch.topk`` on
    distinct values)."""
    order = torch.sort(sal, dim=-1, stable=True).indices
    mask = torch.zeros(sal.shape, dtype=torch.bool, device=sal.device)
    return mask.scatter_(-1, order[..., :prune_n], True)


def _sweep_block(w1: torch.Tensor, hinv1: torch.Tensor, mask1: torch.Tensor,
                 prune_n: int, prune_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential OBS sweep inside one column block, batched over K lanes.

    w1: (K, rows, B), updated in place; hinv1: (K, B, B) upper-triangular
    slice; mask1: (K, rows, B) True = prune, chosen here per m-group when
    ``prune_n`` != 0. Returns (Q1, Err1)."""
    bsz = w1.shape[-1]
    q1 = torch.zeros_like(w1)
    err1 = torch.zeros_like(w1)
    d = torch.diagonal(hinv1, dim1=-2, dim2=-1)  # (K, B)
    for i in range(bsz):
        if prune_n != 0 and i % prune_m == 0:
            # refresh the m-group's mask from the updated weights (:196-198)
            sal = w1[..., i:i + prune_m] ** 2 / d[:, None, i:i + prune_m] ** 2
            mask1[..., i:i + prune_m] = _nm_mask(sal, prune_n)
        w = w1[..., i]
        q = w.masked_fill(mask1[..., i], 0.0)
        err = (w - q) / d[:, i:i + 1]
        # W1[:, i:] -= err (x) Hinv1[i, i:]: columns before i are never
        # written, so a non-finite Hinv entry there cannot reach them
        w1[..., i:].addcmul_(err[..., None], hinv1[:, None, i, i:], value=-1.0)
        q1[..., i] = q
        err1[..., i] = err
    return q1, err1


def _sweep_block_(w1: torch.Tensor, hinv1: torch.Tensor, mask1: Optional[torch.Tensor],
                  prune_n: int, prune_m: int) -> torch.Tensor:
    """Sweep one column block in place (``w1``, a view of the weight,
    becomes Q1) and return Err1: the kernel for a CUDA tensor, else
    ``_sweep_block``. ``mask1`` is None with n:m."""
    if w1.is_cuda:
        err1 = sparsegpt_sweep(w1, hinv1, mask1, prune_n, prune_m)
        count("ecoflap.fine.sweep_kernel")
        return err1
    if mask1 is None:
        mask1 = torch.zeros(w1.shape, dtype=torch.bool, device=w1.device)
    q1, err1 = _sweep_block(w1.clone(), hinv1, mask1, prune_n, prune_m)
    w1.copy_(q1)
    return err1


def sparsegpt_prune_weight_group(
    ws: torch.Tensor,
    hs: torch.Tensor,
    sparsities: Sequence[float],
    blocksize: int = 128,
    percdamp: float = 0.01,
    prune_n: int = 0,
    prune_m: int = 0,
) -> torch.Tensor:
    """Prune K same-shape (out, in) weights ``ws`` (K, out, in) with their
    Hessians ``hs`` (K, in, in) in one batched sweep; returns the pruned
    weights in ``ws``'s dtype. Per lane the result is
    ``sparsegpt_prune_weight``'s up to the batched products' reduction
    order (sparsegpt.py:203-306). The sweep runs in float32, or in float64
    when ``ws`` and ``hs`` are float64."""
    orig_dtype = ws.dtype
    with span("ecoflap.fine.prepare_hinv"):
        w = ws.to(torch.promote_types(ws.dtype, torch.float32)).clone()
        k, rows, cols = w.shape
        hinv, dead = prepare_hinv(hs, percdamp)
        hinv = hinv.contiguous()  # the kernel reads rows of Hinv1 (a no-op as a rule)
        w.masked_fill_(dead[:, None, :], 0.0)
    with span("ecoflap.fine.sweep"):
        for i1 in range(0, cols, blocksize):
            i2 = min(i1 + blocksize, cols)
            w1 = w[..., i1:i2]
            hinv1 = hinv[:, i1:i2, i1:i2]
            mask1 = None
            if prune_n == 0:
                sal = w1 ** 2 / torch.diagonal(hinv1, dim1=-2, dim2=-1)[:, None, :] ** 2
                mask1 = torch.stack([_mask_per_tensor(sal[j], float(sparsities[j]))
                                     for j in range(k)])
            err1 = _sweep_block_(w1, hinv1, mask1, prune_n, prune_m)
            if i2 < cols:
                w[..., i2:] -= torch.bmm(err1, hinv[:, i1:i2, i2:])
    return w.to(orig_dtype)


def sparsegpt_prune_weight(
    w: torch.Tensor,
    h: torch.Tensor,
    sparsity: float,
    blocksize: int = 128,
    percdamp: float = 0.01,
    prune_n: int = 0,
    prune_m: int = 0,
) -> torch.Tensor:
    """Prune one (out, in) weight with the SparseGPT OBS sweep
    (SparseGPT.fasterprune, sparsegpt_pruner.py:84-218); returns the pruned
    weight in ``w``'s dtype."""
    return sparsegpt_prune_weight_group(
        w[None], h[None], [sparsity], blocksize=blocksize, percdamp=percdamp,
        prune_n=prune_n, prune_m=prune_m)[0]
