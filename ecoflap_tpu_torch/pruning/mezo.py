"""Zeroth-order (MeZO) importance scoring, the ECoFLaP coarse stage (port of
``ecoflap_tpu/pruning/mezo.py``).

Reference semantics (``compute_importance_scores_mezo``,
layer_single_base_pruner.py:488-561): for each prunable weight, for each
microbatch and noise draw, evaluate the mean calibration loss at W+eps z and
W-eps z and accumulate ``sum_b | sum_n |L+ - L-| / 2eps |``.

Two ways to evaluate it, the same estimator with the same z:
* the lane ensemble: the targets of one block that a suffix plan covers
  score together (``SuffixPlan.lane_losses``). Lane k's weight is the
  out-of-place copy ``ops.perturb.perturb(w, seed, +-eps)``, the
  hand-written kernel 2 (2 launches per target, microbatch and draw); the
  model is never written.
* the serial path: the reference's own in-place antithetic cycle
  (``zo_perturb_parameters``): +eps, -2eps, +eps with the same z, done by
  the hand-written kernel ``ops.perturb.perturb_inplace`` (3 launches per
  target, microbatch and draw).

``ensemble=None`` (the default) lets each plan choose (``SuffixPlan.lanes``:
BLIP-2's stacks take the ensemble, LLaMA's the serial cycle); True sends
every planned target to the ensemble, as the JAX package's default does;
False sends every target the serial way. Targets no plan covers, and
those a ``LossPlan`` covers (scored by the plan's loss on the plan's data),
always go the serial way. Each ``lane_losses`` call is a span and a count,
``ecoflap.coarse.lanes`` tagged with the stack (``utils/profiling.py``).

Noise modes: ``per_batch`` (default, the reference's sampling) draws a fresh
z per (target, microbatch, draw); ``shared`` draws one z per (target, draw)
for all microbatches and scores ``sum_mb |g+_mb - g-_mb| / 2eps`` over the
per-microbatch mean losses (a documented deviation of the JAX package,
PARITY.md). The kernel seed of a draw comes from the run's integer seed
through ``np.random.SeedSequence`` (``perturb_seed``).

Under a mesh (``parallel.mesh.use_mesh``) each dp rank evaluates its slice
of every global microbatch, and the ranks' per-sample losses are gathered
before the mean, so a microbatch's loss is the whole microbatch's mean on
every rank (the same microbatch partition, so the same estimator). A
microbatch that dp does not divide is evaluated whole on every rank. Both
ways of perturbing read the whole weight (``WeightTarget.full_weight``) and
perturb it with the same Philox counters as one process would, then keep
this rank's slice: the same values, bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ecoflap_tpu_torch.ops.perturb import perturb, perturb_inplace
from ecoflap_tpu_torch.parallel.mesh import dp_gather, dp_slice
from ecoflap_tpu_torch.pruning.plans import SuffixPlan, leading_dim
from ecoflap_tpu_torch.pruning.targets import WeightTarget
from ecoflap_tpu_torch.utils.profiling import count, span

LossFn = Callable[[nn.Module, Any], torch.Tensor]  # -> (B,) per-sample losses
# (target index, microbatch or None in shared mode, noise draw, (out, in)
# shape) -> z
NoiseFn = Callable[[int, Optional[int], int, Tuple[int, ...]], torch.Tensor]
NOISE_MODES = ("per_batch", "shared")


def perturb_seed(seed: int, target: int, batch: Optional[int], draw: int) -> int:
    """64-bit kernel seed for one (target, microbatch, noise draw), from
    ``SeedSequence([seed, target, batch, draw])``; in ``shared`` mode
    (``batch=None``) for one (target, draw), from ``SeedSequence([seed,
    target, draw], spawn_key=(1,))``. The spawn key keeps the shared streams
    apart from every per-batch one: SeedSequence pads its entropy with
    zeros, so [seed, target, draw] alone would be [seed, target, draw, 0]."""
    if batch is None:
        ss = np.random.SeedSequence([seed, target, draw], spawn_key=(1,))
    else:
        ss = np.random.SeedSequence([seed, target, batch, draw])
    words = ss.generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def _scaled(w: torch.Tensor, z: torch.Tensor, scale: float) -> torch.Tensor:
    """w + scale * z with the kernel's arithmetic (float32, one rounding)."""
    return (w.to(torch.float32)
            + z.to(device=w.device, dtype=torch.float32) * scale).to(w.dtype)


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


def _lane_chunks(total: int, num_microbatches: int, lanes: int) -> int:
    """Chunks of the coarse batch for a ``shared``-mode lane group: the
    smallest divisor of ``total`` that is at least microbatches x lanes, so
    a forward of K lanes holds no more samples than a serial forward of one
    microbatch (mezo.py:355-364)."""
    want = min(total, max(1, num_microbatches * lanes))
    return next(c for c in range(want, total + 1) if total % c == 0)


def _units(targets: List[WeightTarget], plans: Sequence[Any],
           ensemble: Optional[bool]):
    """Scoring units in target order: (first index, targets, plan). Where a
    suffix plan takes the ensemble (``ensemble``, or the plan's own
    ``lanes`` when it is None), maximal runs of targets of one block that
    the plan covers form a lane group (mezo.py:466-489); every other target
    is a unit of its own with ``plan=None``: it goes the serial way."""
    def plan_of(t):
        return next((p for p in plans if p.match(t.name)), None)

    units, i = [], 0
    while i < len(targets):
        t, plan = targets[i], plan_of(targets[i])
        j = i + 1
        if isinstance(plan, SuffixPlan) and (
                plan.lanes if ensemble is None else ensemble):
            while (j < len(targets) and targets[j].block_index == t.block_index
                   and plan_of(targets[j]) is plan):
                j += 1
            units.append((i, targets[i:j], plan))
        else:
            units.append((i, [t], None))
        i = j
    return units


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
    ensemble: Optional[bool] = None,
) -> Dict[str, float]:
    """Scalar |projected gradient| score per target.

    Args:
      loss_fn: (model, batch) -> (B,) per-sample losses.
      data: the stacked coarse batch, leading dim = microbatches * bs.
      targets: weights to score, in the adapter's order.
      eps: perturbation scale. num_noise: draws per (target, microbatch), or
        per target in ``shared`` mode.
      seed: integer seed of the kernel's noise streams.
      noise_mode: ``per_batch`` or ``shared`` (module docstring).
      loss_plans: suffix or loss plans; the first whose ``match`` hits a
        target supplies its (loss_fn, data).
      noise: test hook returning z for (target index, microbatch or None in
        ``shared`` mode, draw, shape), used in place of the kernel's stream.
      ensemble: True scores the targets a plan covers by the lane ensemble
        (kernel 2), False by the serial in-place cycle (kernel 1), None as
        each plan's ``lanes`` says.
    Returns {target name: score}.
    """
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    shared = noise_mode == "shared"
    plans = list(loss_plans or [])
    for p in plans:
        p.data  # build every rolling cache before the first perturbation
    batch_size = leading_dim(data)
    two_eps = 2.0 * eps

    # b is the microbatch, None in shared mode (one z for all microbatches)
    def perturb_weight(w, ti, b, n, scale):
        if noise is None:
            perturb_inplace(w, perturb_seed(seed, ti, b, n), scale)
        else:
            w.copy_(_scaled(w, noise(ti, b, n, tuple(w.shape)), scale))

    def lanes(group, ws, i0, b, n, scale):
        if noise is None:
            full = [perturb(w, perturb_seed(seed, i0 + k, b, n), scale)
                    for k, w in enumerate(ws)]
        else:
            full = [_scaled(w, noise(i0 + k, b, n, tuple(w.shape)), scale)
                    for k, w in enumerate(ws)]
        return [t.local_slice(model, w) for t, w in zip(group, full)]

    def microbatches(tdata, static, num):
        """(this rank's slice of microbatch b, b's whole size) per b."""
        size = batch_size // num
        return [(dp_slice(slice_microbatch(tdata, b, num, batch_size, static), size,
                          static), size) for b in range(num)]

    def mean_loss(fn, mb):
        return dp_gather(fn(model, mb[0]), mb[1]).mean()

    def lane_means(plan, mb, paths, lane_ws):
        with span("ecoflap.coarse.lanes", stack=plan.stack.name):
            losses = plan.lane_losses(model, mb[0], paths, lane_ws)
            count("ecoflap.coarse.lanes")
        return dp_gather(losses, mb[1], dim=1)

    def score_serial(ti, t):
        plan = next((p for p in plans if p.match(t.name)), None)
        if plan is not None:
            tfn, tdata, static = plan.loss_fn, plan.prepare(model, t.name), \
                plan.static_keys
        else:
            tfn, tdata, static = loss_fn, data, ()
        # the parameter itself, or a whole copy of a tp-sharded one whose
        # every perturbation is written back to this rank's slice
        w = t.full_weight(model)

        def perturb_in_place(w, ti, b, n, scale):
            perturb_weight(w, ti, b, n, scale)
            t.set_full_weight(model, w)

        mbs = microbatches(tdata, static, num_microbatches)
        score = torch.zeros((), dtype=torch.float32, device=w.device)
        if shared:
            for n in range(num_noise):
                perturb_in_place(w, ti, None, n, eps)
                g_plus = torch.stack([mean_loss(tfn, mb) for mb in mbs])
                perturb_in_place(w, ti, None, n, -2.0 * eps)
                g_minus = torch.stack([mean_loss(tfn, mb) for mb in mbs])
                perturb_in_place(w, ti, None, n, eps)  # restore
                score = score + ((g_plus - g_minus).abs() / two_eps).sum()
            return score
        for b, mb in enumerate(mbs):
            per_batch = torch.zeros((), dtype=torch.float32, device=w.device)
            for n in range(num_noise):
                perturb_in_place(w, ti, b, n, eps)
                l_plus = mean_loss(tfn, mb)
                perturb_in_place(w, ti, b, n, -2.0 * eps)
                l_minus = mean_loss(tfn, mb)
                perturb_in_place(w, ti, b, n, eps)  # restore
                per_batch = per_batch + (l_plus - l_minus).abs() / two_eps
            # reference: gradients_dict[name] += |per_batch| (:549)
            score = score + per_batch.abs()
        return score

    def score_group(i0, group, plan):
        tdata = plan.prepare(model, group[0].name)
        paths = plan.lane_paths(group)
        ws = [t.full_weight(model) for t in group]
        k = len(group)
        score = torch.zeros(k, dtype=torch.float32, device=ws[0].device)
        if shared:
            chunks = microbatches(tdata, plan.static_keys,
                                  _lane_chunks(batch_size, num_microbatches, k))

            def group_means(lane_ws):
                losses = torch.cat([lane_means(plan, c, paths, lane_ws)
                                    for c in chunks], dim=1)
                return losses.reshape(k, num_microbatches, -1).mean(dim=2)

            for n in range(num_noise):
                g_plus = group_means(lanes(group, ws, i0, None, n, eps))
                g_minus = group_means(lanes(group, ws, i0, None, n, -eps))
                score = score + ((g_plus - g_minus).abs() / two_eps).sum(dim=1)
            return score
        for b, mb in enumerate(microbatches(tdata, plan.static_keys, num_microbatches)):
            per_batch = torch.zeros_like(score)
            for n in range(num_noise):
                l_plus = lane_means(plan, mb, paths, lanes(group, ws, i0, b, n, eps))
                l_minus = lane_means(plan, mb, paths, lanes(group, ws, i0, b, n, -eps))
                per_batch = per_batch + (l_plus.mean(dim=1)
                                         - l_minus.mean(dim=1)).abs() / two_eps
            score = score + per_batch.abs()
        return score

    pending: List[torch.Tensor] = []
    with torch.no_grad():
        for i0, group, plan in _units(targets, plans, ensemble):
            if plan is None:
                pending.append(score_serial(i0, group[0]).reshape(1))
            else:
                pending.append(score_group(i0, group, plan))
    vals = torch.cat(pending).cpu().tolist() if pending else []
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
        w = t.full_weight(model).to(torch.float32)
        s = float(leaf_scores[t.name])
        if square:
            out[t.name] = (s * s) * float(w.square().sum())
        else:
            out[t.name] = abs(s) * float(w.abs().sum())
    return out
