"""``TwoStagePruner``: ECoFLaP's coarse sparsity allocation + a local
method, Wanda or SparseGPT (port of ``ecoflap_tpu/pruning/pruners.py``;
reference ``BLIPT5LayerWandaPruner``, wanda_pruner.py:660-876, and the
SparseGPT pruners).

Registered under the reference names ``blipt5_wanda_pruner`` and
``llama_wanda_pruner`` (``TwoStagePruner``), ``blipt5_sparsegpt_pruner`` and
``llama_sparsegpt_pruner`` (``SparseGPTPruner``), as the JAX package
registers its ``WandaPruner`` and ``SparseGPTPruner``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Union

import torch

from ecoflap_tpu_torch.core.device import synchronize
from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.core.spec import parse_prune_spec
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter
from ecoflap_tpu_torch.pruning.allocator import UniformSparsity
from ecoflap_tpu_torch.pruning.engine import stream_prune_stack
from ecoflap_tpu_torch.pruning.mezo import NoiseFn
from ecoflap_tpu_torch.pruning.plans import leading_dim
from ecoflap_tpu_torch.pruning.sparsity import compute_layer_sparsity
from ecoflap_tpu_torch.runners.runner import global_sparsity, read_flat_yaml


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
    coarse stage. ``prune_n``:``prune_m`` > 0 prunes n:m. ``leaf_scores``
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
        prune_n: int = 0,
        prune_m: int = 0,
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
        self.prune_n = prune_n
        self.prune_m = prune_m
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
            ensemble=self.mezo_ensemble, loss_plans=plans,
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
                   for i in range(s.num_blocks) for ln in s.linear_names}
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
        (wanda_pruner.py:799-876). ``phase_times`` then holds the walls of
        the coarse stage and of each stack's fine stage, in seconds."""
        model = self.adapter.model
        dev = next(model.parameters()).device
        t0 = time.time()
        self.phase_times = {}
        global_dict = None
        if self.sparsity_ratio_granularity is not None or self.sparsity_dict is not None:
            specs = [self._spec_for_stack(s.name) for s in self.adapter.stacks
                     if self._spec_for_stack(s.name) is not None]
            if not specs:
                return model, None
            ratios = {parse_prune_spec(s).sparsity for s in specs}
            if len(ratios) != 1:
                raise ValueError("all stacks must share the target sparsity "
                                 "(wanda_pruner.py:807)")
            global_dict = self.get_sparsity(ratios.pop(),
                                            self.sparsity_ratio_granularity)
            synchronize(dev)
            self.phase_times["coarse_s"] = time.time() - t0
        for stack in self.adapter.stacks:
            spec = self._spec_for_stack(stack.name)
            if spec is None:
                continue
            stack_dict = (global_dict if global_dict is not None
                          else UniformSparsity(parse_prune_spec(spec).sparsity))
            ts = time.time()
            split: Optional[Dict[str, float]] = (
                {} if self.local_method == "sparsegpt" else None)
            stream_prune_stack(stack, model, self.data, stack_dict,
                               verbose=self.verbose,
                               num_chunks=self.num_microbatches,
                               method=self.local_method, prune_n=self.prune_n,
                               prune_m=self.prune_m, times=split)
            synchronize(dev)
            self.phase_times[f"fine_{stack.name}_s"] = time.time() - ts
            for k, v in (split or {}).items():
                self.phase_times[f"fine_{stack.name}_{k}"] = v
        if self.verbose:
            print(f"prune spent {time.time() - t0:.3f} s")
        return model, global_dict

    def check_sparsity(self) -> float:
        """Zero fraction over the prunable weights."""
        return global_sparsity(t.weight(self.adapter.model)
                               for t in self.adapter.targets())


class SparseGPTPruner(TwoStagePruner):
    """The same two stages with SparseGPT as the local method."""

    local_method = "sparsegpt"


registry.register("pruner", "blipt5_wanda_pruner", TwoStagePruner)
registry.register("pruner", "llama_wanda_pruner", TwoStagePruner)
registry.register("pruner", "blipt5_sparsegpt_pruner", SparseGPTPruner)
registry.register("pruner", "llama_sparsegpt_pruner", SparseGPTPruner)
