"""Weight targets: reference-named handles on the prunable 2-D weights
(port of ``ecoflap_tpu/pruning/targets.py``). The port stores weights in the
torch ``(out, in)`` layout already, so a target is just (name, stack, block,
local linear name) and resolves to the ``nn.Linear`` weight itself.
Under tensor parallelism that weight is this rank's slice; ``full_weight``
and ``set_full_weight`` read and write the whole of it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ecoflap_tpu_torch.parallel import sharding


@dataclass(frozen=True)
class WeightTarget:
    name: str  # e.g. "t5_model.encoder.block.3.layer.0.SelfAttention.q.weight"
    stack: Any  # StackSpec
    block_index: int
    local: str  # e.g. "layer.0.SelfAttention.q"

    def linear(self, model) -> torch.nn.Linear:
        return self.stack.blocks(model)[self.block_index].get_submodule(self.local)

    def weight(self, model) -> torch.Tensor:
        """The stored (out, in) weight; writes to it change the model."""
        return self.linear(model).weight

    def full_weight(self, model) -> torch.Tensor:
        """The whole weight (``sharding.full_weight``: the parameter itself
        unless it is sharded)."""
        return sharding.full_weight(self.linear(model))

    def set_full_weight(self, model, w: torch.Tensor) -> None:
        sharding.set_full_weight(self.linear(model), w)

    def local_slice(self, model, w: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole-weight-shaped ``w`` (a mask)."""
        return sharding.local_slice(self.linear(model), w)

    def numel(self, model) -> int:
        """Entries of the whole weight."""
        sh = sharding.shard_of(self.linear(model))
        return self.weight(model).numel() * (sh.size if sh is not None else 1)
