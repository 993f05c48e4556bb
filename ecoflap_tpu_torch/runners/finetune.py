"""Masked fine-tuning, the reference's "ECoFLaP w/ FT" rows (port of
``ecoflap_tpu/runners/finetune.py``; reference
UPop/ecoflap_compress_caption.py:82-156, 294-311).

After pruning, every parameter's mask ``p != 0`` is frozen once; then each
step takes the mean of the per-sample losses, its backward, multiplies every
gradient by its mask, steps AdamW and multiplies every parameter by its mask
again, so a pruned entry stays exactly 0 through the weight decay.
``torch.optim.AdamW`` applies optax ``adamw``'s update (decoupled decay on
every parameter, eps outside the square root, bias correction), so a step
holds to the JAX package's on the same gradients. As in the JAX package the
masks cover every parameter, biases and norms too (one that is 0 stays 0).

Under a mesh (``parallel.mesh.use_mesh``) each dp rank takes its slice of
the batch, the per-sample losses are gathered before the mean, and the
gradients are summed over dp before ``masked_update``: the gradient of the
whole batch's mean, the mean of the ranks' gradients. Each tp rank steps its
own slice of a sharded parameter under its own slice of the mask.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from ecoflap_tpu_torch.parallel.mesh import dp_gather, dp_slice, dp_split, dp_sum_
from ecoflap_tpu_torch.pruning.plans import leading_dim

LossFn = Callable[[nn.Module, Any], torch.Tensor]  # -> (B,) per-sample losses


def make_sparsity_masks(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: p != 0}, frozen (finetune.py:27-29)."""
    return {n: p.detach() != 0 for n, p in model.named_parameters()}


@torch.no_grad()
def masked_update(model: nn.Module, optimizer: torch.optim.Optimizer,
                  masks: Dict[str, torch.Tensor]) -> None:
    """The step after the backward (finetune.py:41-53): ``grad *= mask``,
    the optimizer's update, ``param *= mask``. A parameter the loss does
    not reach gets a zero gradient, so the weight decay reaches it as optax
    decays every leaf."""
    params = dict(model.named_parameters())
    for n, p in params.items():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        p.grad.mul_(masks[n])
    optimizer.step()
    for n, p in params.items():
        p.mul_(masks[n])


def train_step(loss_fn: LossFn, model: nn.Module, optimizer: torch.optim.Optimizer,
               masks: Dict[str, torch.Tensor], batch: Any) -> float:
    """One masked step on ``batch``; returns its mean loss."""
    optimizer.zero_grad(set_to_none=True)
    n = leading_dim(batch)
    loss = dp_gather(loss_fn(model, dp_slice(batch, n)), n).mean()
    loss.backward()
    if dp_split(n):
        for p in model.parameters():
            if p.grad is not None:
                dp_sum_(p.grad)
    masked_update(model, optimizer, masks)
    return float(loss.detach())


def adamw(model: nn.Module, learning_rate: float = 1e-5,
          weight_decay: float = 0.05) -> torch.optim.Optimizer:
    """AdamW with optax ``adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def finetune(loss_fn: LossFn, model: nn.Module, batches: Iterable[Any],
             learning_rate: float = 1e-5, weight_decay: float = 0.05,
             optimizer: Optional[torch.optim.Optimizer] = None,
             verbose: bool = False) -> Tuple[nn.Module, List[float]]:
    """Masked fine-tuning of ``model`` in place over ``batches`` (the UPop
    runs' AdamW, lr 1e-5, weight decay 0.05). Returns (model, losses). The
    parameters take gradients for the run and are frozen again after it."""
    masks = make_sparsity_masks(model)
    was_training = model.training
    model.requires_grad_(True)
    model.train(False)  # no dropout in the port's models; eval-mode numerics
    if optimizer is None:
        optimizer = adamw(model, learning_rate, weight_decay)
    losses = []
    try:
        for i, batch in enumerate(batches):
            with torch.enable_grad():
                losses.append(train_step(loss_fn, model, optimizer, masks, batch))
            if verbose:
                print(f"step {i}: loss {losses[-1]:.4f}")
    finally:
        model.requires_grad_(False)
        model.train(was_training)
    return model, losses
