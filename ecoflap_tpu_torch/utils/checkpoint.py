"""Torch ``.pth`` checkpoints under the reference key names (the port's own
copy of the ``.pth`` I/O of ``ecoflap_tpu/utils/checkpoint.py``).

The port's models store their weights in the torch ``(out, in)`` layout
under the reference names, so a model's ``state_dict`` is the reference
checkpoint: the keys that ``export_blip2`` (checkpoint.py:456-473),
``export_llama`` (:291), ``export_t5`` (:227) and ``export_blip1`` (:803)
write and ``convert_clip`` (:342) reads, in float32 as they write them.
``state_dict`` leaves out non-persistent buffers. A BLIP-1 model loads with
``convert_blip1``'s semantics (``load_blip1``). ConvNeXt, OPT and BLIP-2
OPT keep FB's and HF's names, so ``load_into`` and ``export_state_dict``
are their converters (the JAX ``convert_``/``export_convnext``, ``_opt``
and ``_blip2_opt``); ``load_into`` ignores BLIP-2 OPT's tied
``opt_model.lm_head.weight``, which the export leaves out.
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
    is remapped first when the model is BLIP-2. A BLIP-1 model goes through
    ``load_blip1``. Returns the number of keys ignored."""
    if getattr(model, "kind", "").startswith("blip_"):
        return load_blip1(model, state)
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


def unsaved_parameters(model: nn.Module) -> StateDict:
    """The parameters a state-dict hook leaves out of ``model.state_dict()``
    (NLVR's averaged layers' merge layers), by name; a parameter the state
    dict holds under another name (CLIP's ``in_proj``) is not one."""
    saved = {id(t) for t in model.state_dict(keep_vars=True).values()}
    return {n: p for n, p in model.named_parameters(remove_duplicate=False)
            if id(p) not in saved}


# heads a BLIP-1 checkpoint may lack: they keep the model's values
_BLIP1_OPTIONAL = ("vision_proj.", "text_proj.", "itm_head.", "cls_head.")
# the LM head's tied decoder is read from the word embedding and
# predictions.bias, as convert_bert_stack reads it
_TIED = (".cls.predictions.decoder.weight", ".cls.predictions.decoder.bias")


@torch.no_grad()
def load_blip1(model: nn.Module, state: StateDict) -> int:
    """``convert_blip1``'s ``load_state_dict(strict=False)`` semantics
    (checkpoint.py:734-800): the ViT and the text towers must be there (a
    missing key raises ``KeyError``), the heads a checkpoint lacks
    (``vision_proj``, ``text_proj``, ``itm_head``, ``cls_head``) keep the
    model's values, the momentum shadows and every other extra key are
    ignored and counted. NLVR (``_convert_nlvr_text``, :677-727): a base
    checkpoint's single-stream cross-attention fills both twins, and a
    ``merge_layer`` the checkpoint lacks (every averaged layer's, and all
    of a base checkpoint's) is zero. Returns the number of keys ignored."""
    state = dict(state)
    if model.kind == "blip_nlvr":
        for k in list(state):
            if ".crossattention.self." in k:
                for twin in (".self0.", ".self1."):
                    state.setdefault(k.replace(".self.", twin), state[k])
            elif ".crossattention.output.dense." in k:
                for twin in (".dense0.", ".dense1."):
                    state.setdefault(k.replace(".dense.", twin), state[k])
    own = dict(model.state_dict())
    own.update(unsaved_parameters(model))  # the averaged layers' merge_layer
    used = set()
    missing = []
    for name, t in own.items():
        if name.endswith(_TIED):
            continue
        if name not in state:
            if ".merge_layer." in name:
                t.zero_()
            elif not name.startswith(_BLIP1_OPTIONAL):
                missing.append(name)
            continue
        src = state[name]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)} vs "
                             f"the model's {tuple(t.shape)}")
        t.copy_(src)
        used.add(name)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the {model.kind} model's "
                       f"keys, e.g. {sorted(missing)[:3]}")
    return len(set(state) - used - {k for k in own if k.endswith(_TIED)})
