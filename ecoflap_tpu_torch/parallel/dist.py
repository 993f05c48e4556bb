"""Process-group start-up, the ``init_distributed_mode`` of the reference
(LAVIS/lavis/common/dist_utils.py:57-90; port of
``ecoflap_tpu/parallel/dist.py``).

A run of N ranks is started by ``torchrun`` (``python -m
torch.distributed.run --nproc-per-node N ...``), which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` for every
rank. The backend follows the device: ``nccl`` on ``cuda``, ``gloo`` on the
CPU. There is no fallback from one to the other: a failed start raises.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed_mode(device="cuda",
                          init_fn: Optional[Callable[..., None]] = None) -> bool:
    """Start the default process group if the environment asks for one.
    Returns True when a group is up (started here or before).

    The environment, as ``torchrun`` sets it:
      * ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` -> a
        group of ``WORLD_SIZE`` ranks over ``tcp://MASTER_ADDR:MASTER_PORT``
        (``WORLD_SIZE=1`` too: one rank in a group). On ``cuda``
        ``torch.cuda.set_device(LOCAL_RANK)`` comes first;
      * ``WORLD_SIZE`` > 1 without the rest is a half-configured run ->
        ``RuntimeError`` (not the reference's silent single-process run);
      * nothing set -> a single-process no-op, False.

    ``init_fn`` replaces ``torch.distributed.init_process_group`` in tests.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    device = torch.device(device)
    env = {k: os.environ.get(k) for k in ENV_KEYS}
    world = int(env["WORLD_SIZE"] or 0)
    complete = all(env[k] for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))
    if not complete:
        if world > 1:
            missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if not env[k]]
            raise RuntimeError(
                f"WORLD_SIZE={world} but {', '.join(missing)} unset; a multi-rank "
                "run needs RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (start it "
                "with torchrun)")
        return False
    rank = int(env["RANK"])
    if device.type == "cuda":
        torch.cuda.set_device(int(env["LOCAL_RANK"] or 0))
    init = init_fn or dist.init_process_group
    init(backend=backend_for(device),
         init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
         world_size=world, rank=rank)
    logging.info("distributed: rank %d/%d (%s)", rank, world, backend_for(device))
    return True


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func):
    """Decorator: run only on rank 0 (dist_utils.py:107-114)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)

    return wrapper


def same_on_every_rank(obj):
    """Rank 0's ``obj`` on every rank (a broadcast; ``obj`` itself without a
    process group): the CLIs' result, identical on all ranks."""
    if not is_dist_avail_and_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def destroy() -> None:
    """Tear the default group down, if one is up (the CLIs' exit)."""
    if is_dist_avail_and_initialized():
        dist.destroy_process_group()
