"""Model-adapter protocol, the seam between the pruning core and the models
(port of ``ecoflap_tpu/pruning/adapter.py``).

A model family supplies its prunable ``stacks`` (how to build a stack's
inputs, how to run one block with optional inline statistics, where its
blocks live), a per-sample calibration ``loss_fn`` and, optionally, suffix
or loss plans for the zeroth-order stage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch import nn

from ecoflap_tpu_torch.pruning.targets import WeightTarget

GRANULARITIES = ("layer", "block", "model")


@dataclass
class StackSpec:
    name: str  # reference prefix of the sparsity keys, e.g. "visual_encoder.blocks"
    num_blocks: int
    linear_names: Tuple[str, ...]
    per_row_mask: bool  # T5 per-row (True) vs ViT per-tensor (False)
    # (model, batch) -> (x0, cache): everything before the stack
    prepare_inputs: Callable[[nn.Module, Any], Tuple[Any, Any]]
    # (block, x, cache, collect) -> (x_out, stats)
    block_forward: Callable[..., Tuple[Any, Dict[str, Any]]]
    # model -> the stack's nn.ModuleList of blocks
    blocks: Callable[[nn.Module], nn.ModuleList]
    # per block, its own linear names, where the blocks differ (LFM2's conv,
    # attention, dense and expert blocks; ``linear_names`` is then empty);
    # None: ``linear_names`` in every block
    block_linears: Optional[Tuple[Tuple[str, ...], ...]] = None

    def linears(self, i: int) -> Tuple[str, ...]:
        """The prunable linears of block ``i``, in the block's order."""
        return self.linear_names if self.block_linears is None else self.block_linears[i]

    def weight_key(self, i: int, local: str) -> str:
        """Reference sparsity-dict key (wanda_pruner.py:275,553)."""
        return f"{self.name}.{i}.{local}.weight"


@dataclass
class LossPlan:
    """A (loss_fn, data) pair for the MeZO targets it ``match``es (port of
    ``LossPlan``, adapter.py:72-85): when a perturbation can only reach a
    suffix of the network, the frozen prefix's activations are computed once,
    with the unperturbed weights, into ``data``, and ``loss_fn(model, data)``
    starts from them; BLIP-1's text-tower targets reuse the image embeddings
    this way. The serial cycle scores a matched target with the plan's loss
    on the plan's data, microbatch by microbatch; the lane ensemble never
    takes a LossPlan (it needs a suffix plan)."""

    match: Callable[[str], bool]
    loss_fn: Callable[[nn.Module, Any], Any]
    data: Any
    static_keys: Tuple[str, ...] = ()

    def prepare(self, model: nn.Module, name: str) -> Any:
        return self.data


@dataclass
class ModelAdapter:
    name: str
    model: nn.Module
    # (model, batch) -> (B,) per-sample calibration losses
    loss_fn: Callable[[nn.Module, Any], Any]
    stacks: List[StackSpec]
    # (model, batch) -> the MeZO stage's plans (SuffixPlan or LossPlan)
    build_mezo_plans: Optional[Callable[..., list]] = None
    # submodel prefix per stack, for ``model`` granularity and
    # prune_per_model, e.g. {"visual_encoder.blocks": "visual_encoder"}
    model_prefixes: Dict[str, str] = field(default_factory=dict)

    def targets(self) -> List[WeightTarget]:
        """Every prunable weight in the JAX order: stack, block, linear."""
        return [WeightTarget(s.weight_key(i, local), s, i, local)
                for s in self.stacks
                for i in range(s.num_blocks)
                for local in s.linears(i)]

    def group_mapping(self, granularity: Optional[str]) -> Dict[str, str]:
        """{weight key: group} (adapter.py:138-157; wanda_pruner.py:292-324,
        743-776): none for ``None`` (uniform sparsity); for ``"layer"`` the
        key itself, for ``"block"`` the key's block, for ``"model"`` its
        stack's submodel prefix (the stack name's first part if the adapter
        gives none)."""
        if granularity is None:
            return {}
        if granularity not in GRANULARITIES:
            raise ValueError(f"unknown sparsity_ratio_granularity {granularity!r}")
        mapping: Dict[str, str] = {}
        for t in self.targets():
            if granularity == "layer":
                mapping[t.name] = t.name
            elif granularity == "block":
                mapping[t.name] = f"{t.stack.name}.{t.block_index}"
            else:
                mapping[t.name] = self.model_prefixes.get(
                    t.stack.name, t.stack.name.split(".")[0])
        return mapping
