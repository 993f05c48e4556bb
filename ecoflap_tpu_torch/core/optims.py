"""LR schedules and the optimizer factory (port of
``ecoflap_tpu/core/optims.py``; reference LAVIS/lavis/common/optims.py:117,
``LinearWarmupCosineLRScheduler`` / ``LinearWarmupStepLRScheduler``, and the
AdamW weight-decay split of runner_base.py:102-132).

The schedules are plain functions of the step that compute the JAX
package's optax schedules (``join_schedules`` of a ``linear_schedule`` and a
cosine or step decay); ``make_optimizer`` is ``torch.optim.AdamW`` with no
decay on parameters of fewer than 2 dims (biases, norms) behind a
``LambdaLR`` that sets each step's rate.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Tuple, Union

import torch

from ecoflap_tpu_torch.core.registry import registry

Schedule = Callable[[int], float]


def _linear(start: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: start -> end over ``steps``, then end."""
    return lambda count: start + (end - start) * min(max(count, 0), steps) / steps


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules: ``second`` counts from the boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


@registry.register("lr_scheduler", "linear_warmup_cosine_lr")
def linear_warmup_cosine_lr(init_lr: float, min_lr: float, warmup_steps: int,
                            decay_steps: int, warmup_start_lr: float = -1.0,
                            **_: Any) -> Schedule:
    """Linear warmup, then cosine decay to ``min_lr`` (warmup_start_lr -1:
    start at 0)."""
    start = 0.0 if warmup_start_lr < 0 else warmup_start_lr
    warm = max(warmup_steps, 1)
    span = max(decay_steps - warmup_steps, 1)
    alpha = min_lr / max(init_lr, 1e-12)

    def cosine(count):  # optax.cosine_decay_schedule
        cos = 0.5 * (1 + math.cos(math.pi * min(max(count, 0), span) / span))
        return init_lr * ((1 - alpha) * cos + alpha)

    return _join(_linear(start, init_lr, warm), cosine, warm)


@registry.register("lr_scheduler", "linear_warmup_step_lr")
def linear_warmup_step_lr(init_lr: float, min_lr: float, warmup_steps: int,
                          decay_rate: float = 1.0, steps_per_epoch: int = 1,
                          warmup_start_lr: float = -1.0, **_: Any) -> Schedule:
    """Linear warmup, then a step decay per epoch floored at ``min_lr``."""
    start = 0.0 if warmup_start_lr < 0 else warmup_start_lr
    warm = max(warmup_steps, 1)

    def step_decay(count):
        return max(init_lr * decay_rate ** (count // max(steps_per_epoch, 1)), min_lr)

    return _join(_linear(start, init_lr, warm), step_decay, warm)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: Union[float, Schedule],
                   weight_decay: float = 0.05, beta2: float = 0.999
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(AdamW, its LambdaLR): weight decay on parameters of 2 or more dims
    only (runner_base.py:110-126), betas (0.9, ``beta2``), eps 1e-8 as optax
    ``adamw``; ``lr`` a rate or a schedule of the step, read by the
    scheduler, which the caller steps once per optimizer step."""
    params = [p for p in params if p.requires_grad]
    groups = [{"params": [p for p in params if p.ndim >= 2], "weight_decay": weight_decay},
              {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0}]
    opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=1.0,
                            betas=(0.9, beta2), eps=1e-8)
    sched = lr if callable(lr) else (lambda _: lr)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: float(sched(step)))
