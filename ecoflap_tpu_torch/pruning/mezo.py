"""Zeroth-order (MeZO) importance scoring, the ECoFLaP coarse stage (port of
``ecoflap_tpu/pruning/mezo.py``, serial path).

Reference semantics (``compute_importance_scores_mezo``,
layer_single_base_pruner.py:488-561): for each prunable weight, for each
microbatch and noise draw, evaluate the mean calibration loss at W+eps z and
W-eps z and accumulate ``sum_b | sum_n |L+ - L-| / 2eps |``.

The perturbation is the reference's own in-place antithetic cycle
(``zo_perturb_parameters``): +eps, -2eps, +eps with the same z, done by the
hand-written kernel ``ops.perturb.perturb_inplace`` (3 launches per target,
microbatch and noise draw). Its seed per (target, microbatch, draw) is
derived from the run's integer seed with ``np.random.SeedSequence``.

The JAX package's lane ensemble and ``shared`` noise mode are later work.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ecoflap_tpu_torch.ops.perturb import perturb_inplace
from ecoflap_tpu_torch.pruning.plans import leading_dim
from ecoflap_tpu_torch.pruning.targets import WeightTarget

LossFn = Callable[[nn.Module, Any], torch.Tensor]  # -> (B,) per-sample losses
# (target index, microbatch, noise draw, (out, in) shape) -> z
NoiseFn = Callable[[int, int, int, Tuple[int, ...]], torch.Tensor]


def perturb_seed(seed: int, target: int, batch: int, draw: int) -> int:
    """64-bit kernel seed for one (target, microbatch, noise draw)."""
    words = np.random.SeedSequence([seed, target, batch, draw]).generate_state(
        2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def _add_scaled(w: torch.Tensor, z: torch.Tensor, scale: float) -> None:
    """w += scale * z with the kernel's arithmetic (float32, one rounding)."""
    out = w.to(torch.float32) + z.to(device=w.device, dtype=torch.float32) * scale
    w.copy_(out.to(w.dtype))


def slice_microbatch(data: Any, b: int, num: int, batch_size: int,
                     static_keys: Sequence[str] = ()) -> Any:
    """Microbatch ``b`` of ``num`` as views: tensors whose leading dimension
    is ``batch_size`` are cut, everything else (a shared position bias, the
    static keys) rides whole. So a shared tensor must not lead with a
    dimension that can equal the batch: the models give theirs a leading 1
    (LLaMA's rotary tables are (1, 1, S, Dh), not (S, Dh))."""
    def sel(x):
        if isinstance(x, torch.Tensor):
            if x.ndim >= 1 and x.shape[0] == batch_size:
                return x.reshape(num, -1, *x.shape[1:])[b]
            return x
        if isinstance(x, tuple):
            return tuple(sel(v) for v in x)
        if isinstance(x, dict):
            return {k: (v if k in static_keys else sel(v)) for k, v in x.items()}
        return x

    return sel(data)


def mezo_leaf_scores(
    loss_fn: LossFn,
    model: nn.Module,
    data: Any,
    num_microbatches: int,
    targets: List[WeightTarget],
    eps: float = 1e-3,
    num_noise: int = 1,
    seed: int = 0,
    noise_mode: str = "per_batch",
    loss_plans: Optional[Sequence[Any]] = None,
    noise: Optional[NoiseFn] = None,
) -> Dict[str, float]:
    """Scalar |projected gradient| score per target.

    Args:
      loss_fn: (model, batch) -> (B,) per-sample losses.
      data: the stacked coarse batch, leading dim = microbatches * bs.
      targets: weights to score, in the adapter's order.
      eps: perturbation scale. num_noise: draws per (target, microbatch).
      seed: integer seed of the kernel's noise streams.
      loss_plans: suffix plans; the first whose ``match`` hits a target
        supplies its (loss_fn, data).
      noise: test hook returning z for (target index, microbatch, draw,
        shape), used in place of the kernel's stream.
    Returns {target name: score}.
    """
    if noise_mode == "shared":
        raise NotImplementedError(
            "noise_mode='shared' is not ported yet (ROADMAP.md, 'lane ensemble "
            "and shared noise')")
    if noise_mode != "per_batch":
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    plans = list(loss_plans or [])
    for p in plans:
        p.data  # build every rolling cache before the first perturbation
    batch_size = leading_dim(data)

    def perturb(w, ti, b, n, scale):
        if noise is None:
            perturb_inplace(w, perturb_seed(seed, ti, b, n), scale)
        else:
            _add_scaled(w, noise(ti, b, n, tuple(w.shape)), scale)

    pending: List[torch.Tensor] = []
    with torch.no_grad():
        for ti, t in enumerate(targets):
            plan = next((p for p in plans if p.match(t.name)), None)
            if plan is not None:
                tfn, tdata, static = plan.loss_fn, plan.prepare(model, t.name), \
                    plan.static_keys
            else:
                tfn, tdata, static = loss_fn, data, ()
            w = t.weight(model)
            score = torch.zeros((), dtype=torch.float32, device=w.device)
            for b in range(num_microbatches):
                mb = slice_microbatch(tdata, b, num_microbatches, batch_size,
                                      static)
                per_batch = torch.zeros((), dtype=torch.float32, device=w.device)
                for n in range(num_noise):
                    perturb(w, ti, b, n, eps)
                    l_plus = tfn(model, mb).mean()
                    perturb(w, ti, b, n, -2.0 * eps)
                    l_minus = tfn(model, mb).mean()
                    perturb(w, ti, b, n, eps)  # restore
                    per_batch = per_batch + (l_plus - l_minus).abs() / (2.0 * eps)
                # reference: gradients_dict[name] += |per_batch| (:549)
                score = score + per_batch.abs()
            pending.append(score)
    vals = torch.stack(pending).cpu().tolist() if pending else []
    return {t.name: float(v) for t, v in zip(targets, vals)}


def mezo_group_sums(model: nn.Module, targets: List[WeightTarget],
                    leaf_scores: Dict[str, float],
                    score_compute: str = "MEZO-GradOnly") -> Dict[str, float]:
    """Per-target importance sums. The MeZO score is a scalar s per tensor,
    so sum(|W| s) = s sum|W| and sum(W^2 s^2) = s^2 sum W^2 (mezo.py:540-580)."""
    if score_compute == "MEZO-GradOnly":
        return {t.name: abs(float(leaf_scores[t.name])) for t in targets}
    if score_compute not in ("MEZO-GradMagAbs", "MEZO-GradMagSquare"):
        raise ValueError(f"unknown MeZO score method {score_compute!r}")
    square = score_compute == "MEZO-GradMagSquare"
    out: Dict[str, float] = {}
    for t in targets:
        w = t.weight(model).to(torch.float32)
        s = float(leaf_scores[t.name])
        if square:
            out[t.name] = (s * s) * float(w.square().sum())
        else:
            out[t.name] = abs(s) * float(w.abs().sum())
    return out
