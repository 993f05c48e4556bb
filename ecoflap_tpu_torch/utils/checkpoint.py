"""Torch ``.pth`` checkpoints under the reference key names (the port's own
copy of the ``.pth`` I/O of ``ecoflap_tpu/utils/checkpoint.py``).

The port's models store their weights in the torch ``(out, in)`` layout
under the reference names, so a model's ``state_dict`` is the reference
checkpoint: the keys that ``export_blip2`` (checkpoint.py:456-473),
``export_llama`` (:291) and ``export_t5`` (:227) write and ``convert_clip``
(:342) reads, in float32 as they write them. ``state_dict`` leaves out
non-persistent buffers.
"""

from __future__ import annotations

import re
from typing import Dict

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def load_torch_checkpoint(path: str) -> StateDict:
    """A ``.pth`` state dict, unwrapped from a ``{"model": ...}`` training
    checkpoint (checkpoint.py:35-42). Only tensors and plain containers are
    unpickled (``weights_only``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return obj


def save_torch_checkpoint(state: StateDict, path: str) -> None:
    """checkpoint.py:45-48."""
    torch.save(dict(state), path)


def remap_eva_clip_to_blip2(state: StateDict) -> StateDict:
    """``visual.`` -> ``visual_encoder.`` cross-model key remap
    (checkpoint.py:593-596; wanda_pruner.py:570-585)."""
    return {re.sub(r"^visual\.", "visual_encoder.", k): v for k, v in state.items()}


def export_state_dict(model: nn.Module) -> StateDict:
    """A float32 CPU copy of the model's parameters and persistent buffers,
    under their reference names: what ``--save_pruned_model`` writes."""
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in model.state_dict().items()}


@torch.no_grad()
def load_into(model: nn.Module, state: StateDict) -> int:
    """Copy ``state`` into ``model``, casting to each tensor's dtype and
    device. A key the model has and ``state`` lacks raises ``KeyError``, as
    does a shape that differs; keys the model lacks are ignored and counted
    (a reference checkpoint carries more than the pruned towers). A state
    with EVA-CLIP's ``visual.`` keys and none of BLIP-2's ``visual_encoder.``
    is remapped first when the model is BLIP-2. Returns the number of keys
    ignored."""
    own = model.state_dict()
    if (any(k.startswith("visual.") for k in state)
            and not any(k.startswith("visual_encoder.") for k in state)
            and any(k.startswith("visual_encoder.") for k in own)):
        state = remap_eva_clip_to_blip2(state)
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the model's "
                       f"{len(own)} keys, e.g. {missing[:3]}")
    for name, t in own.items():
        src = state[name]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)} vs "
                             f"the model's {tuple(t.shape)}")
        t.copy_(src)
    return len(set(state) - set(own))


def export_eva_clip_visual(model: nn.Module) -> StateDict:
    """EVA-CLIP's ``--save_pruned_model`` export (cli/prune.py:360-367;
    reference evaluate_eva_clip.py:414-428): the visual tower under
    ``visual.`` without its last block, the 39 blocks BLIP-2's EVA ViT-g
    has, float32."""
    last = f"blocks.{model.cfg.eva_visual.depth - 1}."
    return {k: v for k, v in export_state_dict(model).items()
            if k.startswith("visual.") and last not in k}
