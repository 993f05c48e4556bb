"""Load the JAX package's BLIP-2 or LLaMA parameters into the port's model.

``flat`` is the JAX pytree as numpy arrays under dotted names (what
``ecoflap_tpu.core.pytree.flatten_named`` gives). Stacked ``(L, ...)`` leaves
split into the per-block modules, ``(in, out)`` kernels transpose to
``(out, in)``, ``scale`` becomes a norm's ``weight``, and the T5 relative
bias tables move onto block 0 as in HF. LLaMA takes the HF names that
``ecoflap_tpu/utils/checkpoint.py:export_llama`` writes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ecoflap_tpu_torch.models import llama as llama_mod
from ecoflap_tpu_torch.models import t5 as t5_mod

Flat = Dict[str, np.ndarray]


def _dense(sd, name, flat, src, i=None, bias=True):
    k = flat[f"{src}.kernel"]
    sd[f"{name}.weight"] = (k if i is None else k[i]).T
    if bias:
        b = flat[f"{src}.bias"]
        sd[f"{name}.bias"] = b if i is None else b[i]


def _norm(sd, name, flat, src, i=None, bias=True):
    s = flat[f"{src}.scale"]
    sd[f"{name}.weight"] = s if i is None else s[i]
    if bias:
        b = flat[f"{src}.bias"]
        sd[f"{name}.bias"] = b if i is None else b[i]


def jax_to_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    """The port's state dict (reference names) from the JAX flat params, by
    the model family of ``cfg``."""
    if isinstance(cfg, llama_mod.LlamaConfig):
        return _llama_state_dict(flat, cfg)
    return _blip2_state_dict(flat, cfg)


def _llama_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": flat["embed_tokens"],
        "model.norm.weight": flat["norm.scale"],
        "lm_head.weight": flat["lm_head.kernel"].T,
    }
    for i in range(cfg.num_layers):
        tl = f"model.layers.{i}"
        _norm(sd, f"{tl}.input_layernorm", flat, "layers.input_ln", i, bias=False)
        _norm(sd, f"{tl}.post_attention_layernorm", flat, "layers.post_ln", i,
              bias=False)
        for local, path in llama_mod.LOCAL_TO_PATH.items():
            _dense(sd, f"{tl}.{local}", flat, f"layers.{path}", i, bias=False)
    return sd


def _blip2_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    v, pv = cfg.vit, "visual_encoder"
    pe = flat[f"{pv}.patch_embed.kernel"]  # (C*p*p, d), rows ordered (C, ph, pw)
    sd[f"{pv}.patch_embed.proj.weight"] = pe.T.reshape(
        v.embed_dim, v.in_chans, v.patch_size, v.patch_size)
    sd[f"{pv}.patch_embed.proj.bias"] = flat[f"{pv}.patch_embed.bias"]
    sd[f"{pv}.cls_token"] = flat[f"{pv}.cls_token"]
    sd[f"{pv}.pos_embed"] = flat[f"{pv}.pos_embed"]
    jb = f"{pv}.blocks"
    for i in range(v.depth):
        tb = f"{pv}.blocks.{i}"
        _norm(sd, f"{tb}.norm1", flat, f"{jb}.norm1", i)
        _dense(sd, f"{tb}.attn.qkv", flat, f"{jb}.attn.qkv", i, bias=False)
        sd[f"{tb}.attn.q_bias"] = flat[f"{jb}.attn.q_bias"][i]
        sd[f"{tb}.attn.v_bias"] = flat[f"{jb}.attn.v_bias"][i]
        _dense(sd, f"{tb}.attn.proj", flat, f"{jb}.attn.proj", i)
        _norm(sd, f"{tb}.norm2", flat, f"{jb}.norm2", i)
        _dense(sd, f"{tb}.mlp.fc1", flat, f"{jb}.mlp.fc1", i)
        _dense(sd, f"{tb}.mlp.fc2", flat, f"{jb}.mlp.fc2", i)

    _norm(sd, "ln_vision", flat, "ln_vision")
    sd["query_tokens"] = flat["query_tokens"]
    qb = "Qformer.bert"
    _norm(sd, f"{qb}.embeddings.LayerNorm", flat, "qformer.embeddings_ln")
    for i in range(cfg.qformer.num_layers):
        jl, tl = f"qformer.layers.{i}", f"{qb}.encoder.layer.{i}"
        for jn, tn in (("self_attn", "attention"), ("cross_attn", "crossattention")):
            if f"{jl}.{jn}.query.kernel" not in flat:
                continue
            for proj in ("query", "key", "value"):
                _dense(sd, f"{tl}.{tn}.self.{proj}", flat, f"{jl}.{jn}.{proj}")
            _dense(sd, f"{tl}.{tn}.output.dense", flat, f"{jl}.{jn}.output.dense")
            _norm(sd, f"{tl}.{tn}.output.LayerNorm", flat, f"{jl}.{jn}.output.ln")
        _dense(sd, f"{tl}.intermediate_query.dense", flat, f"{jl}.ffn.intermediate")
        _dense(sd, f"{tl}.output_query.dense", flat, f"{jl}.ffn.output.dense")
        _norm(sd, f"{tl}.output_query.LayerNorm", flat, f"{jl}.ffn.output.ln")
    _dense(sd, "t5_proj", flat, "t5_proj")

    t = cfg.t5
    sd["t5_model.shared.weight"] = flat["t5_model.shared"]
    sd["t5_model.lm_head.weight"] = flat["t5_model.lm_head.kernel"].T
    for which, n, linears in (("encoder", t.num_layers, t5_mod.ENCODER_LINEARS),
                              ("decoder", t.num_decoder_layers, t5_mod.DECODER_LINEARS)):
        js, ts = f"t5_model.{which}", f"t5_model.{which}"
        sd[f"{ts}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            flat[f"{js}.rel_bias"])
        sd[f"{ts}.final_layer_norm.weight"] = flat[f"{js}.final_ln.scale"]
        local_to_path = {
            "SelfAttention": "attn" if which == "encoder" else "self_attn",
            "EncDecAttention": "cross_attn", "DenseReluDense": "mlp"}
        for i in range(n):
            for j in range(len({ln.split(".")[1] for ln in linears})):
                sd[f"{ts}.block.{i}.layer.{j}.layer_norm.weight"] = (
                    flat[f"{js}.blocks.ln{j}.scale"][i])
            for ln in linears:
                _, _, mod, proj = ln.split(".")
                _dense(sd, f"{ts}.block.{i}.{ln}", flat,
                       f"{js}.blocks.{local_to_path[mod]}.{proj}", i, bias=False)
    return sd


@torch.no_grad()
def load_jax_params(model, flat: Flat) -> None:
    """Copy the JAX params into ``model`` in place, casting to each
    parameter's dtype. Every port parameter must be covered exactly."""
    sd = jax_to_state_dict({k: np.asarray(a) for k, a in flat.items()}, model.cfg)
    own = model.state_dict()
    missing, extra = set(own) - set(sd), set(sd) - set(own)
    if missing or extra:
        raise KeyError(f"JAX params do not match the model: missing "
                       f"{sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")
    for name, p in own.items():
        src = torch.from_numpy(np.array(sd[name], dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)} vs "
                             f"{tuple(p.shape)}")
        p.copy_(src)
