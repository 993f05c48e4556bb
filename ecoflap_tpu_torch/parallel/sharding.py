"""Tensor-parallel placement of the weights, and the dp slice of a batch
(port of ``ecoflap_tpu/parallel/sharding.py``).

The rule table is the JAX table (sharding.py:39-62) over the port's own
parameter names (the reference's) in the torch ``(out, in)`` layout:

* column-parallel kernels (JAX ``COL``, the out axis) shard dim 0:
  qkv / q / k / v / in_proj, fc1 / c_fc / wi_0 / wi_1 / gate / up;
* row-parallel kernels (``ROW``, the in axis) shard dim 1:
  proj / o / out_proj / fc2 / c_proj / wo / down;
* ``shared`` / ``embed_tokens`` / ``token_embedding`` (JAX ``COL2`` on
  ``(vocab, d)``) shard ``d``, dim 1; ``lm_head`` shards the vocab, dim 0;
  ``patch_embed`` shards its output channels, dim 0;
* EVA's ``q_bias`` / ``v_bias`` follow their kernel's out axis, dim 0;
* everything else is replicated.

As ``_fit_spec`` does (sharding.py:74-85), a dim that the tp extent does
not divide is replicated. The JAX rules match stacked-block names that
several families share; the port's names spell the block index, so each
JAX rule becomes the port rules of the families whose names it matches
(``tests/test_torch_parallel.py`` holds every parameter of every tiny
family against the JAX table through ``models/convert.py``).

``shard_params`` leaves a matched parameter as this rank's slice, a plain
``nn.Parameter`` of the slice's shape, and records on its module
(``TP_ATTR``) the dim, the tp group, the rank and the extent.
``models/layers.py`` reads that record to join the ranks' products;
``full_weight`` / ``set_full_weight`` are the one seam through which
pruning reads and writes a weight that may be sharded.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ecoflap_tpu_torch.parallel.mesh import Mesh, all_gather_cat, rank_slice

TP_ATTR = "_tp_shards"

_B = r".*blocks\.\d+\."  # EVA / DeiT / BLIP ViT blocks
_T5 = r".*\.layer\.\d+\.(SelfAttention|EncDecAttention)\."
_DEC = r".*layers\.\d+\."  # LLaMA and OPT decoder layers
_RES = r".*resblocks\.\d+\."  # CLIP towers

RULES: List[Tuple[str, int]] = [
    # --- EVA ViT / generic blocks (sharding.py:41-48) ---
    (_B + r"attn\.qkv\.weight$", 0),
    (_B + r"attn\.proj\.weight$", 1),
    (_B + r"mlp\.fc1\.weight$", 0),
    (_B + r"mlp\.fc2\.weight$", 1),
    (_B + r"attn\.(q_bias|v_bias)$", 0),
    # CLIP's attn.in_proj / out_proj and mlp.c_fc / c_proj
    (_RES + r"attn\.in_proj\.weight$", 0),
    (_RES + r"attn\.out_proj\.weight$", 1),
    (_RES + r"mlp\.c_fc\.weight$", 0),
    (_RES + r"mlp\.c_proj\.weight$", 1),
    # --- T5 attention and MLP (:50-51, :45-46) ---
    (_T5 + r"(q|k|v)\.weight$", 0),
    (_T5 + r"o\.weight$", 1),
    (r".*\.layer\.\d+\.DenseReluDense\.(wi_0|wi_1)\.weight$", 0),
    (r".*\.layer\.\d+\.DenseReluDense\.wo\.weight$", 1),
    # --- LLaMA and OPT layers (:53-56); OPT's fc1 / fc2 match no JAX rule ---
    (_DEC + r"self_attn\.(q_proj|k_proj|v_proj)\.weight$", 0),
    (_DEC + r"self_attn\.(o_proj|out_proj)\.weight$", 1),
    (_DEC + r"mlp\.(gate_proj|up_proj)\.weight$", 0),
    (_DEC + r"mlp\.down_proj\.weight$", 1),
    # --- embeddings / heads (:58-61) ---
    (r"(.*\.)?(shared|embed_tokens|token_embedding)\.weight$", 1),
    (r"(.*\.)?lm_head\.weight$", 0),
    (r"(.*\.)?patch_embed\.proj\.weight$", 0),
]


@dataclass(frozen=True)
class TPShard:
    dim: int
    group: Any
    rank: int
    size: int


def rule_for(name: str) -> Optional[int]:
    """The dim that the first matching rule shards, or None (replicated)."""
    for pat, dim in RULES:
        if re.match(pat, name):
            return dim
    return None


def placement(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim of parameter ``name`` that a tp extent of ``tp`` shards, or
    None: no rule, or a dim that ``tp`` does not divide (``_fit_spec``)."""
    dim = rule_for(name)
    if dim is None or dim >= len(shape) or shape[dim] % tp:
        return None
    return dim


def shard_of(module: nn.Module, pname: str = "weight") -> Optional[TPShard]:
    # the record is a plain attribute, so it sits in the instance dict; a
    # getattr would take nn.Module's raising __getattr__ on every product
    shards = module.__dict__.get(TP_ATTR)
    return None if shards is None else shards.get(pname)


def _resolve(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    mod, _, pname = name.rpartition(".")
    return (model.get_submodule(mod) if mod else model), pname


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace every rule-matched parameter by this rank's tp slice, in
    place; a no-op at tp = 1. A parameter that two modules share is
    replaced, and recorded, at both."""
    if mesh.tp == 1:
        return model
    local: Dict[int, nn.Parameter] = {}
    for name, p in list(model.named_parameters(remove_duplicate=False)):
        dim = placement(name, p.shape, mesh.tp)
        if dim is None:
            continue
        if id(p) not in local:
            part = rank_slice(p.detach(), dim, mesh.tp_rank, mesh.tp).clone()
            local[id(p)] = nn.Parameter(part, requires_grad=p.requires_grad)
        mod, pname = _resolve(model, name)
        setattr(mod, pname, local[id(p)])
        shards = dict(getattr(mod, TP_ATTR, {}))
        shards[pname] = TPShard(dim, mesh.tp_group, mesh.tp_rank, mesh.tp)
        setattr(mod, TP_ATTR, shards)
    return model


@torch.no_grad()
def unshard_params(model: nn.Module) -> nn.Module:
    """The inverse of ``shard_params``: every sharded parameter gathered
    back to its full shape on every rank (a collective)."""
    full: Dict[int, nn.Parameter] = {}
    for mod in list(model.modules()):
        shards = getattr(mod, TP_ATTR, None)
        if not shards:
            continue
        for pname, sh in shards.items():
            p = getattr(mod, pname)
            if id(p) not in full:
                w = all_gather_cat(p.detach(), sh.dim, sh.group, sh.size)
                full[id(p)] = nn.Parameter(w, requires_grad=p.requires_grad)
            setattr(mod, pname, full[id(p)])
        delattr(mod, TP_ATTR)
    return model


@torch.no_grad()
def full_weight(module: nn.Module, pname: str = "weight") -> torch.Tensor:
    """The whole weight: the parameter itself when it is not sharded (so
    in-place writes reach the model), else a gathered copy (a collective
    over tp; write it back with ``set_full_weight``)."""
    w = getattr(module, pname)
    sh = shard_of(module, pname)
    if sh is None:
        return w
    return all_gather_cat(w.detach(), sh.dim, sh.group, sh.size)


@torch.no_grad()
def set_full_weight(module: nn.Module, w: torch.Tensor, pname: str = "weight") -> None:
    """Write the whole weight ``w``: a sharded parameter keeps this rank's
    slice; an unsharded one takes ``w`` unless it is ``w``."""
    p = getattr(module, pname)
    sh = shard_of(module, pname)
    if sh is not None:
        w = rank_slice(w, sh.dim, sh.rank, sh.size)
    if w is not p:
        p.copy_(w)


def local_slice(module: nn.Module, w: torch.Tensor, pname: str = "weight") -> torch.Tensor:
    """This rank's slice of a whole-weight-shaped ``w`` of ``module.pname``
    (``w`` itself when the parameter is not sharded, or when ``w`` only
    broadcasts against it, as a per-tensor mask of one entry does)."""
    sh = shard_of(module, pname)
    if sh is None or tuple(w.shape) != full_shape(module, pname):
        return w
    return rank_slice(w, sh.dim, sh.rank, sh.size)


def full_shape(module: nn.Module, pname: str = "weight") -> Tuple[int, ...]:
    """The shape of the whole parameter."""
    shape = list(getattr(module, pname).shape)
    sh = shard_of(module, pname)
    if sh is not None:
        shape[sh.dim] *= sh.size
    return tuple(shape)


def shard_batch(batch: Any, mesh: Optional[Mesh] = None,
                batch_size: Optional[int] = None) -> Any:
    """This rank's dp slice of every leaf whose leading dim is the batch's
    (``batch_size``, default the first tensor's); a batch that dp does not
    divide rides whole on every rank (sharding.py:123-130)."""
    from ecoflap_tpu_torch.parallel.mesh import dp_slice, use_mesh
    from ecoflap_tpu_torch.pruning.plans import leading_dim

    with use_mesh(mesh):
        return dp_slice(batch, batch_size if batch_size is not None
                        else leading_dim(batch))


def _length(batch: Any) -> Optional[int]:
    vals = batch.values() if isinstance(batch, dict) else [batch]
    for v in vals:
        if hasattr(v, "__len__") and not isinstance(v, (str, bytes)):
            return len(v)
    return None


def dp_map(fn: Callable[[Any], Any]) -> Callable[[Any], Any]:
    """``fn`` over this rank's dp slice of each batch (every list, array or
    tensor whose length is the batch's), the ranks' outputs gathered in rank
    order: the same output as ``fn`` over the whole batch, on every rank. An
    evaluation's predictions this way; a batch that dp does not divide, or
    no active mesh with dp > 1, runs ``fn`` whole."""
    import numpy as np
    import torch.distributed as dist

    from ecoflap_tpu_torch.parallel.mesh import current

    def cut(x, n, m):
        if hasattr(x, "__len__") and not isinstance(x, (str, bytes)) and len(x) == n:
            k = n // m.dp
            return x[m.dp_rank * k:(m.dp_rank + 1) * k]
        return x

    def wrapped(batch):
        m = current()
        n = _length(batch)
        if m is None or m.dp == 1 or not n or n % m.dp:
            return fn(batch)
        local = ({k: cut(v, n, m) for k, v in batch.items()}
                 if isinstance(batch, dict) else cut(batch, n, m))
        out = fn(local)
        if isinstance(out, torch.Tensor):
            out = out.cpu()
        parts: List[Any] = [None] * m.dp
        dist.all_gather_object(parts, out, group=m.dp_group)
        if isinstance(out, torch.Tensor):
            return torch.cat(parts)
        if isinstance(out, np.ndarray):
            return np.concatenate(parts)
        return [x for part in parts for x in part]

    return wrapped
