"""``TwoStagePruner``: ECoFLaP's coarse sparsity allocation + local Wanda
(port of ``ecoflap_tpu/pruning/pruners.py`` for ``local_method="wanda"``;
reference ``BLIPT5LayerWandaPruner``, wanda_pruner.py:660-876).

Registered under the reference names ``blipt5_wanda_pruner`` and
``llama_wanda_pruner``, as the JAX package registers its ``WandaPruner``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

import torch

from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.core.spec import parse_prune_spec
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter
from ecoflap_tpu_torch.pruning.allocator import UniformSparsity
from ecoflap_tpu_torch.pruning.engine import stream_prune_stack
from ecoflap_tpu_torch.pruning.mezo import NoiseFn
from ecoflap_tpu_torch.pruning.plans import leading_dim
from ecoflap_tpu_torch.pruning.sparsity import compute_layer_sparsity
from ecoflap_tpu_torch.runners.runner import global_sparsity


def _slice(tree: Any, n: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, n) for k, v in tree.items()}
    return tree[:n]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TwoStagePruner:
    """Args mirror the reference kwargs (layer_single_base_pruner.py:19-63).
    ``seed`` keys the coarse stage's noise; ``noise`` is the tests' hook that
    replaces it (mezo.py). A given ``sparsity_dict`` skips the coarse stage.
    ``leaf_scores`` receives the coarse stage's per-target scores (MeZO
    scores, or first-order importance sums for ``Grad*`` methods). The fine
    stage forwards one microbatch at a time (engine.py)."""

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
        sparsity_dict: Optional[Mapping[str, float]] = None,
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
        self.sparsity_dict = sparsity_dict
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
            return dict(self.sparsity_dict)
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
            noise_eps=self.noise_eps, seed=self.seed, loss_plans=plans,
            noise=self.noise, leaf_scores_out=self.leaf_scores,
            verbose=self.verbose)

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
            _sync(dev)
            self.phase_times["coarse_s"] = time.time() - t0
        for stack in self.adapter.stacks:
            spec = self._spec_for_stack(stack.name)
            if spec is None:
                continue
            stack_dict = (global_dict if global_dict is not None
                          else UniformSparsity(parse_prune_spec(spec).sparsity))
            ts = time.time()
            stream_prune_stack(stack, model, self.data, stack_dict,
                               verbose=self.verbose,
                               num_chunks=self.num_microbatches)
            _sync(dev)
            self.phase_times[f"fine_{stack.name}_s"] = time.time() - ts
        if self.verbose:
            print(f"prune spent {time.time() - t0:.3f} s")
        return model, global_dict

    def check_sparsity(self) -> float:
        """Zero fraction over the prunable weights."""
        return global_sparsity(t.weight(self.adapter.model)
                               for t in self.adapter.targets())


registry.register("pruner", "blipt5_wanda_pruner", TwoStagePruner)
registry.register("pruner", "llama_wanda_pruner", TwoStagePruner)
