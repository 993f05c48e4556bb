"""``TwoStagePruner``: ECoFLaP's coarse sparsity allocation + a local
method, Wanda or SparseGPT; ``GlobalPruner``: the global-mask baselines
(port of ``ecoflap_tpu/pruning/pruners.py``; reference
``BLIPT5LayerWandaPruner``, wanda_pruner.py:660-876, the SparseGPT pruners,
and global_pruner.py:56-244).

Registered under the reference names ``blipt5_wanda_pruner``,
``llama_wanda_pruner``, ``t5_wanda_pruner``, ``vit_wanda_pruner`` and
``clip_wanda_pruner``, for BLIP-1 ``bert_wanda_pruner`` and
``blipbert_wanda_pruner``, and for the image classifiers
``deit_wanda_pruner``, ``vit_classifier_wanda_pruner`` and
``convnext_wanda_pruner``, and for LFM2-MoE ``lfm2_wanda_pruner``
(``TwoStagePruner``), ``blipt5_sparsegpt_pruner``,
``llama_sparsegpt_pruner``, ``t5_sparsegpt_pruner``, ``vit_sparsegpt_pruner``
and ``clip_sparsegpt_pruner`` (``SparseGPTPruner``),
``blipt5_global_mag_pruner`` and ``llama_magnitude_pruner`` (magnitude),
``blipt5_global_gradmagabs_pruner`` (|W| |G|) and
``blipt5_global_mezo_pruner`` (MeZO), as the JAX package registers them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.core.spec import parse_prune_spec
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter
from ecoflap_tpu_torch.pruning.allocator import UniformSparsity
from ecoflap_tpu_torch.pruning.engine import stream_prune_stack
from ecoflap_tpu_torch.pruning.first_order import first_order_importance
from ecoflap_tpu_torch.pruning.masks import (
    global_mask,
    iterative_sparsity_schedule,
    layerwise_mask,
)
from ecoflap_tpu_torch.pruning.mezo import NoiseFn, mezo_leaf_scores
from ecoflap_tpu_torch.pruning.plans import leading_dim
from ecoflap_tpu_torch.pruning.sparsity import compute_layer_sparsity
from ecoflap_tpu_torch.runners.runner import global_sparsity, read_flat_yaml
from ecoflap_tpu_torch.utils.profiling import Recording, recording, span

# the ``phase_times`` key of each span and counter a prune records; the
# fields are the span's tags
SPAN_KEYS = {
    "ecoflap.coarse": "coarse_s",
    "ecoflap.coarse.lanes": "coarse_{stack}_lanes_s",
    "ecoflap.fine": "fine_{stack}_s",
    "ecoflap.fine.collect": "fine_{stack}_collect_s",
    "ecoflap.fine.prune": "fine_{stack}_prune_s",
    "ecoflap.fine.prepare_hinv": "fine_{stack}_prepare_hinv_s",
    "ecoflap.fine.sweep": "fine_{stack}_sweep_s",
    "ecoflap.fine.reforward": "fine_{stack}_reforward_s",
    "ecoflap.global.iteration": "iteration_{iteration}_s",
    "ecoflap.global.select": "iteration_{iteration}_select_s",
    "ecoflap.model.moe": "moe_s",
}
COUNT_KEYS = {
    "ecoflap.coarse.lanes": "coarse_{stack}_lanes_n",
    "ecoflap.fine.sweep_kernel": "fine_{stack}_sweep_kernels_n",
    "ecoflap.model.moe.expert_calls": "moe_expert_calls_n",
    "ecoflap.model.moe.idle_experts": "moe_idle_experts_n",
}


def phase_times(rec: Recording) -> Dict[str, float]:
    """A recording's span totals (seconds) and counts under their
    ``phase_times`` keys (``SPAN_KEYS``, ``COUNT_KEYS``)."""
    out: Dict[str, float] = {}
    for keys, totals in ((SPAN_KEYS, rec.seconds), (COUNT_KEYS, rec.counts)):
        for (name, tags), v in totals.items():
            if name in keys:
                k = keys[name].format(**dict(tags))
                out[k] = out.get(k, 0) + v
    return out


def _slice(tree: Any, n: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, n) for k, v in tree.items()}
    return tree[:n]


class TwoStagePruner:
    """Args mirror the reference kwargs (layer_single_base_pruner.py:19-63)
    and the JAX ``pruner_cfg`` names (cli/prune.py:650-667). ``seed`` keys
    the coarse stage's noise; ``noise`` is the tests' hook that replaces it
    (mezo.py); ``mezo_ensemble`` True scores by the lane ensemble (kernel
    2), False by the serial in-place cycle (kernel 1), None as each suffix
    plan chooses (``mezo_leaf_scores``). A given
    ``sparsity_dict`` (a mapping, or the path of a saved YAML) skips the
    coarse stage. ``prune_per_model`` allocates the budget per submodel
    (``adapter.model_prefixes``). ``prune_n``:``prune_m`` > 0 prunes n:m.
    ``hessian_bf16`` rounds SparseGPT's summed Gram matrices once to bf16
    (engine.py). ``leaf_scores``
    receives the coarse stage's per-target scores (MeZO scores, or
    first-order importance sums for ``Grad*`` methods). The fine stage
    forwards one microbatch at a time (engine.py)."""

    local_method = "wanda"

    def __init__(
        self,
        adapter: ModelAdapter,
        data: Dict[str, torch.Tensor],
        num_microbatches: int,
        prune_spec: Optional[str] = None,
        stack_specs: Optional[Mapping[str, Optional[str]]] = None,
        sparsity_ratio_granularity: Optional[str] = None,
        max_sparsity_per_layer: float = 0.8,
        score_method: str = "MEZO-GradOnly_sum",
        num_data_first_stage: int = 128,
        num_noise: int = 1,
        noise_eps: float = 1e-3,
        noise_mode: str = "per_batch",
        mezo_ensemble: Optional[bool] = None,
        sparsity_dict: Optional[Union[str, Mapping[str, float]]] = None,
        prune_per_model: bool = False,
        prune_n: int = 0,
        prune_m: int = 0,
        hessian_bf16: bool = False,
        seed: int = 0,
        noise: Optional[NoiseFn] = None,
        verbose: bool = True,
    ) -> None:
        self.adapter = adapter
        self.data = data
        self.num_microbatches = num_microbatches
        self.prune_spec = prune_spec
        self.stack_specs = dict(stack_specs or {})
        self.sparsity_ratio_granularity = sparsity_ratio_granularity
        self.max_sparsity_per_layer = max_sparsity_per_layer
        self.score_method = score_method
        self.num_data_first_stage = num_data_first_stage
        self.num_noise = num_noise
        self.noise_eps = noise_eps
        self.noise_mode = noise_mode
        self.mezo_ensemble = mezo_ensemble
        self.sparsity_dict = sparsity_dict
        self.prune_per_model = prune_per_model
        self.prune_n = prune_n
        self.prune_m = prune_m
        self.hessian_bf16 = hessian_bf16
        self.seed = seed
        self.noise = noise
        self.verbose = verbose
        self.leaf_scores: Dict[str, float] = {}
        self.phase_times: Dict[str, float] = {}

    def _spec_for_stack(self, stack_name: str) -> Optional[str]:
        return self.stack_specs.get(stack_name, self.prune_spec)

    def _coarse_data(self):
        """The first ``num_data_first_stage`` samples, rounded down to whole
        microbatches (the reference's count-limited loader, drop-last)."""
        total = leading_dim(self.data)
        bs = max(1, total // self.num_microbatches)
        num_mb = max(1, min(self.num_data_first_stage, total) // bs)
        return _slice(self.data, num_mb * bs), num_mb

    def get_sparsity(self, original_sparsity: float,
                     sparsity_ratio_granularity: Optional[str]):
        """Sparsity dict for the fine stage (wanda_pruner.py:292-340)."""
        if self.sparsity_dict is not None:
            sd = self.sparsity_dict
            return self._adapt_sparsity_dict(
                read_flat_yaml(sd) if isinstance(sd, str) else dict(sd))
        mapping = self.adapter.group_mapping(sparsity_ratio_granularity)
        data, num_mb = self._coarse_data()
        # the suffix plans serve both methods: MeZO evaluates suffixes
        # through their rolling caches, first-order streams each planned
        # stack's backward block by block (and builds no cache)
        plans = None
        if self.adapter.build_mezo_plans is not None:
            plans = self.adapter.build_mezo_plans(self.adapter.model, data)
        return compute_layer_sparsity(
            self.adapter.loss_fn, self.adapter.model, data, num_mb,
            self.adapter.targets(), original_sparsity, mapping,
            max_sparsity_per_layer=self.max_sparsity_per_layer,
            score_method=self.score_method, num_noise=self.num_noise,
            noise_eps=self.noise_eps, seed=self.seed, noise_mode=self.noise_mode,
            ensemble=self.mezo_ensemble, prune_per_model=self.prune_per_model,
            per_model_group=list(dict.fromkeys(self.adapter.model_prefixes.values())),
            loss_plans=plans,
            noise=self.noise, leaf_scores_out=self.leaf_scores,
            verbose=self.verbose)

    def _adapt_sparsity_dict(self, sd: Dict[str, float]) -> Dict[str, float]:
        """Cross-model reuse of a sparsity dict (pruners.py:206-245,
        wanda_pruner.py:570-585), over the stacks being pruned only:
        ``visual_encoder.`` keys remap to ``visual.`` and back, targets the
        source model lacks are filled with 0 (kept dense), loudly, and a dict
        that covers under half the targets raises ``KeyError``."""
        pruned = [s for s in self.adapter.stacks
                  if self._spec_for_stack(s.name) is not None]
        targets = {s.weight_key(i, ln) for s in pruned
                   for i in range(s.num_blocks) for ln in s.linears(i)}
        if targets <= set(sd):
            return sd
        out = dict(sd)
        for a, b in (("visual_encoder.", "visual."), ("visual.", "visual_encoder.")):
            if any(k.startswith(a) for k in sd) and any(t.startswith(b) for t in targets):
                for k, v in sd.items():
                    if k.startswith(a):
                        out.setdefault(b + k[len(a):], v)
        missing = sorted(t for t in targets if t not in out)
        if missing:
            covered = len(targets) - len(missing)
            if covered < 0.5 * len(targets):
                raise KeyError(
                    f"--sparsity_dict covers only {covered}/{len(targets)} targets "
                    f"(first missing: {missing[:3]}) -- wrong dict for this model")
            print(f"sparsity_dict: zero-filling {len(missing)} targets the source "
                  f"model lacks (kept dense): {missing[:4]}"
                  f"{' ...' if len(missing) > 4 else ''}")
            for t in missing:
                out[t] = 0.0
        return out

    def prune(self):
        """(model, sparsity dict), the reference ``prune()`` contract
        (wanda_pruner.py:799-876). ``phase_times`` then holds, in seconds
        on the device's clock (``utils/profiling.py``), the coarse stage
        (``coarse_s``) and each stack's fine stage (``fine_<stack>_s``)
        with its statistics passes, pruning and re-forwards
        (``_collect_s``, ``_prune_s``, ``_reforward_s``; SparseGPT's pruning
        holds ``_prepare_hinv_s`` and ``_sweep_s``); the lane ensemble's
        forwards per stack (``coarse_<stack>_lanes_s``); a sparse-expert
        model's expert layers in both stages (``moe_s``, forwards only).
        Counts end in ``_n``: the lane forwards (``coarse_<stack>_lanes_n``),
        the sweep kernel's launches on the card
        (``fine_<stack>_sweep_kernels_n``), and the expert layers' experts
        that got tokens and those that got none (``moe_expert_calls_n``,
        ``moe_idle_experts_n``). A key is there when its phase ran."""
        model = self.adapter.model
        t0 = time.time()
        global_dict = None
        with recording(next(model.parameters()).device) as rec:
            specs = [self._spec_for_stack(s.name) for s in self.adapter.stacks
                     if self._spec_for_stack(s.name) is not None]
            if specs and (self.sparsity_ratio_granularity is not None
                          or self.sparsity_dict is not None):
                ratios = {parse_prune_spec(s).sparsity for s in specs}
                if len(ratios) != 1:
                    raise ValueError("all stacks must share the target sparsity "
                                     "(wanda_pruner.py:807)")
                with span("ecoflap.coarse"):
                    global_dict = self.get_sparsity(ratios.pop(),
                                                    self.sparsity_ratio_granularity)
            for stack in self.adapter.stacks:
                spec = self._spec_for_stack(stack.name)
                if spec is None:
                    continue
                stack_dict = (global_dict if global_dict is not None
                              else UniformSparsity(parse_prune_spec(spec).sparsity))
                with span("ecoflap.fine", stack=stack.name):
                    stream_prune_stack(
                        stack, model, self.data, stack_dict, verbose=self.verbose,
                        num_chunks=self.num_microbatches, method=self.local_method,
                        prune_n=self.prune_n, prune_m=self.prune_m,
                        collect=("hessian_bf16" if self.hessian_bf16
                                 and self.local_method == "sparsegpt" else None))
        self.phase_times = phase_times(rec)
        if self.verbose:
            print(f"prune spent {time.time() - t0:.3f} s")
        return model, global_dict

    def check_sparsity(self) -> float:
        """Zero fraction over the prunable weights."""
        return global_sparsity(t.full_weight(self.adapter.model)
                               for t in self.adapter.targets())


class SparseGPTPruner(TwoStagePruner):
    """The same two stages with SparseGPT as the local method."""

    local_method = "sparsegpt"


class GlobalPruner:
    """The global-mask baselines (pruners.py:523-636; global_pruner.py:56-244).
    For each step p_i = target^(iteration / i) of the schedule, score every
    target, zero the scores the last step pruned, and prune to p_i by one
    threshold over all targets (``is_global``), one per submodel prefix
    (``is_global`` and ``prune_per_model``), or one per tensor. Scores: ``mag``
    |W|; ``gradmagabs`` |W| |G| over the first ``num_samples`` samples
    (first_order.py); ``mezo`` the |MeZO score| of each tensor, a scalar,
    so whole tensors are kept or dropped, by the serial in-place cycle on
    the full loss (no suffix plans: kernel 1, 3 launches per target,
    microbatch and draw). Each weight is multiplied in place by its mask
    (``w * m``, as the JAX package prunes, so a pruned negative weight is
    -0.0). Takes and ignores the two-stage pruner's other settings, as the
    JAX package does for a non-global configuration. ``phase_times`` gets
    each step's seconds and its selection's (``iteration_<i>_s``,
    ``iteration_<i>_select_s``, on the device's clock);
    ``importance_stats`` each step's float32 importance bytes and non-finite
    entries; ``leaf_scores`` the last step's MeZO scores."""

    score = "mag"

    def __init__(
        self,
        adapter: ModelAdapter,
        data: Dict[str, torch.Tensor],
        num_microbatches: int,
        prune_spec: Optional[str] = None,
        stack_specs: Optional[Mapping[str, Optional[str]]] = None,
        is_global: bool = True,
        prune_per_model: bool = False,
        iteration: int = 1,
        num_samples: int = 64,
        num_noise: int = 1,
        noise_eps: float = 1e-3,
        noise_mode: str = "per_batch",
        seed: int = 0,
        noise: Optional[NoiseFn] = None,
        verbose: bool = True,
        **_: Any,
    ) -> None:
        self.adapter = adapter
        self.data = data
        self.num_microbatches = num_microbatches
        self.prune_spec = prune_spec
        self.stack_specs = dict(stack_specs or {})
        self.is_global = is_global
        self.prune_per_model = prune_per_model
        self.iteration = iteration
        self.num_samples = num_samples
        self.num_noise = num_noise
        self.noise_eps = noise_eps
        self.noise_mode = noise_mode
        self.seed = seed
        self.noise = noise
        self.verbose = verbose
        self.leaf_scores: Dict[str, float] = {}
        self.phase_times: Dict[str, float] = {}
        self.importance_stats: List[Dict[str, int]] = []

    def _score_data(self):
        """The first ``num_samples`` samples, rounded down to whole
        microbatches (pruners.py:562-571)."""
        total = leading_dim(self.data)
        bs = max(1, total // self.num_microbatches)
        num_mb = max(1, min(self.num_samples, total) // bs)
        return _slice(self.data, num_mb * bs), num_mb

    def _importance(self, targets) -> Dict[str, torch.Tensor]:
        model = self.adapter.model
        if self.score == "mag":
            return {t.name: t.full_weight(model).to(torch.float32).abs()
                    for t in targets}
        data, num_mb = self._score_data()
        if self.score == "gradmagabs":
            # the suffix plans stream each stack's backward block by block
            plans = (self.adapter.build_mezo_plans(model, data)
                     if self.adapter.build_mezo_plans is not None else None)
            return first_order_importance(self.adapter.loss_fn, model, data, num_mb,
                                          targets, "GradMagAbs", plans=plans)
        if self.score == "mezo":
            scores = mezo_leaf_scores(
                self.adapter.loss_fn, model, data, num_mb, targets, eps=self.noise_eps,
                num_noise=self.num_noise, seed=self.seed, noise_mode=self.noise_mode,
                noise=self.noise)
            self.leaf_scores = scores
            dev = next(model.parameters()).device
            return {k: torch.tensor([abs(v)], dtype=torch.float32, device=dev)
                    for k, v in scores.items()}
        raise ValueError(f"unknown global score {self.score!r}")

    def _masks(self, imp: Dict[str, torch.Tensor], p: float) -> Dict[str, torch.Tensor]:
        if not self.is_global:
            return layerwise_mask(imp, p)
        if not self.prune_per_model:
            return global_mask(imp, p, max_sparsity_per_layer=1.0)
        masks: Dict[str, torch.Tensor] = {}
        # both T5 stacks of BLIP-2 share one prefix: visited once (JAX visits
        # it twice, to the same masks)
        for prefix in dict.fromkeys(self.adapter.model_prefixes.values()):
            sub = {k: v for k, v in imp.items() if k.startswith(prefix)}
            masks.update(global_mask(sub, p, max_sparsity_per_layer=1.0))
        return masks

    @torch.no_grad()
    def prune(self):
        """(model, None), the JAX ``GlobalPruner.prune`` contract."""
        model = self.adapter.model
        targets = self.adapter.targets()
        spec = self.prune_spec or next(iter(self.stack_specs.values()), None)
        if spec is None:
            return model, None
        self.importance_stats = []
        masks: Optional[Dict[str, torch.Tensor]] = None
        with recording(next(model.parameters()).device) as rec:
            for i, p_i in enumerate(iterative_sparsity_schedule(
                    parse_prune_spec(spec).sparsity, self.iteration), start=1):
                with span("ecoflap.global.iteration", iteration=i):
                    imp = self._importance(targets)
                    if masks is not None:
                        for k, v in imp.items():
                            v.mul_(masks[k])
                    self.importance_stats.append({
                        "bytes": sum(v.numel() * v.element_size() for v in imp.values()),
                        "nonfinite": int(sum((~torch.isfinite(v)).sum()
                                             for v in imp.values()))})
                    with span("ecoflap.global.select"):
                        masks = self._masks(imp, p_i)
                    del imp
                    for t in targets:
                        t.weight(model).mul_(t.local_slice(model, masks[t.name]))
                if self.verbose:
                    print(f"target sparsity: {p_i:.4f}")
        self.phase_times = phase_times(rec)
        return model, None


class GlobalMagPruner(GlobalPruner):
    score = "mag"


class GlobalGradMagAbsPruner(GlobalPruner):
    score = "gradmagabs"


class GlobalMeZoPruner(GlobalPruner):
    score = "mezo"


for _family in ("blipt5", "llama", "t5", "vit", "clip"):
    registry.register("pruner", f"{_family}_wanda_pruner", TwoStagePruner)
    registry.register("pruner", f"{_family}_sparsegpt_pruner", SparseGPTPruner)
# BLIP-1's text towers (the UPop runs): Wanda only, as in the JAX package
for _name in ("bert_wanda_pruner", "blipbert_wanda_pruner"):
    registry.register("pruner", _name, TwoStagePruner)
# the image classifiers (LLaMA/image_classifiers), and LFM2-MoE on the LLaMA
# recipe: Wanda only
for _name in ("deit_wanda_pruner", "vit_classifier_wanda_pruner", "convnext_wanda_pruner",
              "lfm2_wanda_pruner"):
    registry.register("pruner", _name, TwoStagePruner)
registry.register("pruner", "blipt5_global_mag_pruner", GlobalMagPruner)
registry.register("pruner", "blipt5_global_gradmagabs_pruner", GlobalGradMagAbsPruner)
registry.register("pruner", "blipt5_global_mezo_pruner", GlobalMeZoPruner)
registry.register("pruner", "llama_magnitude_pruner", GlobalMagPruner)
