"""Load the JAX package's parameters into the port's model: BLIP-2, LLaMA,
standalone T5, CLIP / EVA-CLIP, BERT, the four BLIP-1 heads, DeiT and
ConvNeXt, OPT, BLIP-2 OPT and the stage-1 Q-Former.

``flat`` is the JAX pytree as numpy arrays under dotted names (what
``ecoflap_tpu.core.pytree.flatten_named`` gives). Stacked ``(L, ...)`` leaves
split into the per-block modules, ``(in, out)`` kernels transpose to
``(out, in)``, ``scale`` becomes a norm's ``weight``, and the T5 relative
bias tables move onto block 0 as in HF. LLaMA takes the HF names that
``ecoflap_tpu/utils/checkpoint.py:export_llama`` writes, T5 those of
``export_t5`` and CLIP OpenAI's (``convert_clip``, checkpoint.py:316-379),
BERT and BLIP-1 UPop's (``export_bert_stack``, ``export_blip1``,
checkpoint.py:599-849), NLVR's merge layers on every layer, DeiT timm's
(``export_eva_vit``), ConvNeXt FB's (``export_convnext``), OPT HF's
(``export_opt``, ``export_blip2_opt``) and the stage-1 Q-Former LAVIS's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ecoflap_tpu_torch.models import bert as bert_mod
from ecoflap_tpu_torch.models import blip1 as blip1_mod
from ecoflap_tpu_torch.models import blip2_opt, blip2_qformer, classifiers, eva_vit
from ecoflap_tpu_torch.models import clip as clip_mod
from ecoflap_tpu_torch.models import llama as llama_mod
from ecoflap_tpu_torch.models import opt as opt_mod
from ecoflap_tpu_torch.models import t5 as t5_mod
from ecoflap_tpu_torch.utils.checkpoint import unsaved_parameters

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


def jax_to_state_dict(flat: Flat, cfg, model=None) -> Dict[str, np.ndarray]:
    """The port's state dict (reference names) from the JAX flat params, by
    the model family of ``cfg`` (BERT and BLIP-1 read ``model``'s layout:
    an LM head or not, the BLIP-1 head)."""
    if isinstance(cfg, bert_mod.BertConfig):
        sd: Dict[str, np.ndarray] = {}
        lm = isinstance(model, bert_mod.BertLMHeadModel)
        _bert_into(sd, flat, cfg, "", "bert." if lm else "", lm_head=lm)
        return sd
    if isinstance(cfg, blip1_mod.Blip1Config):
        return _blip1_state_dict(flat, cfg, model.kind)
    if isinstance(cfg, llama_mod.LlamaConfig):
        return _llama_state_dict(flat, cfg)
    if isinstance(cfg, t5_mod.T5Config):
        sd: Dict[str, np.ndarray] = {}
        _t5_into(sd, flat, cfg, "")
        return sd
    if isinstance(cfg, clip_mod.CLIPConfig):
        return _clip_state_dict(flat, cfg)
    if isinstance(cfg, eva_vit.EvaViTConfig):  # DeiT
        sd = {}
        _eva_into(sd, flat, cfg, "")
        return sd
    if isinstance(cfg, classifiers.ConvNeXtConfig):
        return _convnext_state_dict(flat, cfg)
    if isinstance(cfg, opt_mod.OPTConfig):
        sd = {}
        _opt_into(sd, flat, cfg, "", "model.decoder.")
        return sd
    if isinstance(cfg, blip2_opt.Blip2OptConfig):
        return _blip2_opt_state_dict(flat, cfg)
    if isinstance(cfg, blip2_qformer.Blip2QformerConfig):
        return _blip2_qformer_state_dict(flat, cfg)
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


def _eva_into(sd, flat: Flat, v, pv: str) -> None:
    """An EVA ViT (``v`` its config) from JAX prefix ``pv`` to port prefix
    ``pv`` ("visual_encoder.", "visual." or "" for DeiT)."""
    pe = flat[f"{pv}patch_embed.kernel"]  # (C*p*p, d), rows ordered (C, ph, pw)
    sd[f"{pv}patch_embed.proj.weight"] = pe.T.reshape(
        v.embed_dim, v.in_chans, v.patch_size, v.patch_size)
    sd[f"{pv}patch_embed.proj.bias"] = flat[f"{pv}patch_embed.bias"]
    sd[f"{pv}cls_token"] = flat[f"{pv}cls_token"]
    sd[f"{pv}pos_embed"] = flat[f"{pv}pos_embed"]
    jb = f"{pv}blocks"
    for i in range(v.depth):
        tb = f"{pv}blocks.{i}"
        _norm(sd, f"{tb}.norm1", flat, f"{jb}.norm1", i)
        full = v.qkv_bias_mode == "full"  # BLIP-1's ViT-B, DeiT
        _dense(sd, f"{tb}.attn.qkv", flat, f"{jb}.attn.qkv", i, bias=full)
        if not full:
            sd[f"{tb}.attn.q_bias"] = flat[f"{jb}.attn.q_bias"][i]
            sd[f"{tb}.attn.v_bias"] = flat[f"{jb}.attn.v_bias"][i]
        _dense(sd, f"{tb}.attn.proj", flat, f"{jb}.attn.proj", i)
        _norm(sd, f"{tb}.norm2", flat, f"{jb}.norm2", i)
        _dense(sd, f"{tb}.mlp.fc1", flat, f"{jb}.mlp.fc1", i)
        _dense(sd, f"{tb}.mlp.fc2", flat, f"{jb}.mlp.fc2", i)
    if v.final_norm:
        _norm(sd, f"{pv}norm", flat, f"{pv}norm")
    if v.head_dim:
        _dense(sd, f"{pv}head", flat, f"{pv}head")


def _t5_into(sd, flat: Flat, t, prefix: str) -> None:
    """A T5 (``t`` its config) from JAX prefix ``prefix`` ("" standalone,
    "t5_model." in BLIP-2) to the same port prefix."""
    sd[f"{prefix}shared.weight"] = flat[f"{prefix}shared"]
    sd[f"{prefix}lm_head.weight"] = flat[f"{prefix}lm_head.kernel"].T
    for which, n, linears in (("encoder", t.num_layers, t5_mod.ENCODER_LINEARS),
                              ("decoder", t.num_decoder_layers, t5_mod.DECODER_LINEARS)):
        js = ts = f"{prefix}{which}"
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


def _blip2_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _eva_into(sd, flat, cfg.vit, "visual_encoder.")
    _norm(sd, "ln_vision", flat, "ln_vision")
    sd["query_tokens"] = flat["query_tokens"]
    _qformer_into(sd, flat, cfg.qformer, "qformer.")
    _dense(sd, "t5_proj", flat, "t5_proj")
    _t5_into(sd, flat, cfg.t5, "t5_model.")
    return sd


def _qformer_into(sd, flat: Flat, q, jp: str, text: bool = False) -> None:
    """The Q-Former (``q`` its config) from JAX prefix ``jp`` to
    ``Qformer.bert``; ``text`` adds the stage-1 model's text embeddings and
    each layer's text FFN (``intermediate``/``output``)."""
    qb = "Qformer.bert"
    _norm(sd, f"{qb}.embeddings.LayerNorm", flat, f"{jp}embeddings_ln")
    if text:
        sd[f"{qb}.embeddings.word_embeddings.weight"] = flat[f"{jp}word_embeddings"]
        sd[f"{qb}.embeddings.position_embeddings.weight"] = flat[f"{jp}position_embeddings"]
    for i in range(q.num_layers):
        jl, tl = f"{jp}layers.{i}", f"{qb}.encoder.layer.{i}"
        for jn, tn in (("self_attn", "attention"), ("cross_attn", "crossattention")):
            if f"{jl}.{jn}.query.kernel" not in flat:
                continue
            for proj in ("query", "key", "value"):
                _dense(sd, f"{tl}.{tn}.self.{proj}", flat, f"{jl}.{jn}.{proj}")
            _dense(sd, f"{tl}.{tn}.output.dense", flat, f"{jl}.{jn}.output.dense")
            _norm(sd, f"{tl}.{tn}.output.LayerNorm", flat, f"{jl}.{jn}.output.ln")
        ffns = (("_query", "ffn"), ("", "text_ffn")) if text else (("_query", "ffn"),)
        for suffix, jf in ffns:
            _dense(sd, f"{tl}.intermediate{suffix}.dense", flat, f"{jl}.{jf}.intermediate")
            _dense(sd, f"{tl}.output{suffix}.dense", flat, f"{jl}.{jf}.output.dense")
            _norm(sd, f"{tl}.output{suffix}.LayerNorm", flat, f"{jl}.{jf}.output.ln")


def _blip2_qformer_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {"query_tokens": flat["query_tokens"]}
    _qformer_into(sd, flat, cfg.qformer, "", text=True)
    for head in ("vision_proj", "text_proj", "itm_head"):
        _dense(sd, head, flat, head)
    return sd


def _opt_into(sd, flat: Flat, o, jp: str, tp: str) -> None:
    """An OPT decoder (``o`` its config) from JAX prefix ``jp`` to the HF
    names under ``tp`` (``export_opt``, checkpoint.py:870-907)."""
    sd[f"{tp}embed_tokens.weight"] = flat[f"{jp}embed_tokens"]
    sd[f"{tp}embed_positions.weight"] = flat[f"{jp}embed_positions"]
    _norm(sd, f"{tp}final_layer_norm", flat, f"{jp}final_ln")
    for i in range(o.num_layers):
        tl = f"{tp}layers.{i}"
        _norm(sd, f"{tl}.self_attn_layer_norm", flat, f"{jp}layers.ln1", i)
        _norm(sd, f"{tl}.final_layer_norm", flat, f"{jp}layers.ln2", i)
        for local, path in opt_mod.LOCAL_TO_PATH.items():
            _dense(sd, f"{tl}.{local}", flat, f"{jp}layers.{path}", i)


def _blip2_opt_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {"query_tokens": flat["query_tokens"]}
    _eva_into(sd, flat, cfg.vit, "visual_encoder.")
    _norm(sd, "ln_vision", flat, "ln_vision")
    _qformer_into(sd, flat, cfg.qformer, "qformer.")
    _dense(sd, "opt_proj", flat, "opt_proj")
    _opt_into(sd, flat, cfg.opt, "opt_model.", "opt_model.model.decoder.")
    return sd


def _convnext_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    """FB's names (``export_convnext``, checkpoint.py:987-1000): the stem and
    downsample kernels' rows are in (C, kh, kw) order, the depthwise kernel
    (7, 7, C) becomes (C, 1, 7, 7)."""
    sd: Dict[str, np.ndarray] = {}
    _norm(sd, "norm", flat, "norm")
    _dense(sd, "head", flat, "head")
    cin = 3
    for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        jd, td = f"stages.{si}.downsample", f"downsample_layers.{si}"
        conv, ln = (f"{td}.0", f"{td}.1") if si == 0 else (f"{td}.1", f"{td}.0")
        k = flat[f"{jd}.conv.kernel"]
        side = int(round((k.shape[0] // cin) ** 0.5))
        sd[f"{conv}.weight"] = k.T.reshape(dim, cin, side, side)
        sd[f"{conv}.bias"] = flat[f"{jd}.conv.bias"]
        _norm(sd, ln, flat, f"{jd}.norm")
        jb = f"stages.{si}.blocks"
        for i in range(depth):
            tb = f"stages.{si}.{i}"
            sd[f"{tb}.dwconv.weight"] = np.transpose(
                flat[f"{jb}.dwconv.kernel"][i], (2, 0, 1))[:, None]
            sd[f"{tb}.dwconv.bias"] = flat[f"{jb}.dwconv.bias"][i]
            _norm(sd, f"{tb}.norm", flat, f"{jb}.norm", i)
            _dense(sd, f"{tb}.pwconv1", flat, f"{jb}.pwconv1", i)
            _dense(sd, f"{tb}.pwconv2", flat, f"{jb}.pwconv2", i)
            sd[f"{tb}.gamma"] = flat[f"{jb}.gamma"][i]
        cin = dim
    return sd


def _resblocks_into(sd, flat: Flat, tower: str, jprefix: str, n: int) -> None:
    """A resblock stack, JAX ``{jprefix}.blocks`` to OpenAI's
    ``{tower}.resblocks`` (``attn.in_proj_weight``, checkpoint.py:316-339)."""
    jb = f"{jprefix}.blocks"
    for i in range(n):
        tb = f"{tower}.resblocks.{i}"
        _norm(sd, f"{tb}.ln_1", flat, f"{jb}.ln_1", i)
        sd[f"{tb}.attn.in_proj_weight"] = flat[f"{jb}.attn.in_proj.kernel"][i].T
        sd[f"{tb}.attn.in_proj_bias"] = flat[f"{jb}.attn.in_proj.bias"][i]
        _dense(sd, f"{tb}.attn.out_proj", flat, f"{jb}.attn.out_proj", i)
        _norm(sd, f"{tb}.ln_2", flat, f"{jb}.ln_2", i)
        _dense(sd, f"{tb}.mlp.c_fc", flat, f"{jb}.mlp.c_fc", i)
        _dense(sd, f"{tb}.mlp.c_proj", flat, f"{jb}.mlp.c_proj", i)


def _clip_state_dict(flat: Flat, cfg) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {
        "token_embedding.weight": flat["text.token_embedding"],
        "positional_embedding": flat["text.positional_embedding"],
        "text_projection": flat["text.text_projection"],
        "logit_scale": flat["logit_scale"],
    }
    _norm(sd, "ln_final", flat, "text.ln_final")
    _resblocks_into(sd, flat, "transformer", "text", cfg.text.layers)
    if cfg.eva_visual is not None:
        _eva_into(sd, flat, cfg.eva_visual, "visual.")
        return sd
    v = cfg.visual
    sd["visual.conv1.weight"] = flat["visual.conv1.kernel"].T.reshape(
        v.width, 3, v.patch_size, v.patch_size)
    sd["visual.class_embedding"] = flat["visual.class_embedding"]
    sd["visual.positional_embedding"] = flat["visual.positional_embedding"]
    sd["visual.proj"] = flat["visual.proj"]
    _norm(sd, "visual.ln_pre", flat, "visual.ln_pre")
    _norm(sd, "visual.ln_post", flat, "visual.ln_post")
    _resblocks_into(sd, flat, "visual.transformer", "visual", v.layers)
    return sd


def _bert_into(sd, flat: Flat, cfg, jp: str, tp: str, lm_head: bool = False,
               nlvr: bool = False) -> None:
    """A BERT tower from JAX prefix ``jp`` to the port's ``tp`` (``bert.``
    inside an LM head model); ``lm_head`` adds the ``cls`` head at
    ``tp``'s ``cls.``, tied decoder included; ``nlvr`` the twin cross."""
    sd[f"{tp}embeddings.word_embeddings.weight"] = flat[f"{jp}embeddings.word"]
    sd[f"{tp}embeddings.position_embeddings.weight"] = flat[f"{jp}embeddings.position"]
    _norm(sd, f"{tp}embeddings.LayerNorm", flat, f"{jp}embeddings.ln")
    jb = f"{jp}blocks"
    cross = ((("self0", "query", "key", "value"), ("self1", "query1", "key1", "value1"))
             if nlvr else (("self", "query", "key", "value"),))
    for i in range(cfg.num_layers):
        tl = f"{tp}encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            _dense(sd, f"{tl}.attention.self.{proj}", flat, f"{jb}.attn.{proj}", i)
        _dense(sd, f"{tl}.attention.output.dense", flat, f"{jb}.attn.out", i)
        _norm(sd, f"{tl}.attention.output.LayerNorm", flat, f"{jb}.attn.ln", i)
        if cfg.add_cross_attention:
            for name, *projs in cross:
                for proj, src in zip(("query", "key", "value"), projs):
                    _dense(sd, f"{tl}.crossattention.{name}.{proj}", flat,
                           f"{jb}.cross.{src}", i)
            outs = (("dense0", "out"), ("dense1", "out1"), ("merge_layer", "merge")) \
                if nlvr else (("dense", "out"),)
            for name, src in outs:
                _dense(sd, f"{tl}.crossattention.output.{name}", flat, f"{jb}.cross.{src}", i)
            _norm(sd, f"{tl}.crossattention.output.LayerNorm", flat, f"{jb}.cross.ln", i)
        _dense(sd, f"{tl}.intermediate.dense", flat, f"{jb}.ffn.intermediate", i)
        _dense(sd, f"{tl}.output.dense", flat, f"{jb}.ffn.out", i)
        _norm(sd, f"{tl}.output.LayerNorm", flat, f"{jb}.ffn.ln", i)
    if lm_head:
        cp = tp[:-len("bert.")] + "cls.predictions"
        _dense(sd, f"{cp}.transform.dense", flat, f"{jp}cls.transform")
        _norm(sd, f"{cp}.transform.LayerNorm", flat, f"{jp}cls.transform_ln")
        sd[f"{cp}.bias"] = sd[f"{cp}.decoder.bias"] = flat[f"{jp}cls.decoder_bias"]
        sd[f"{cp}.decoder.weight"] = flat[f"{jp}embeddings.word"]


def _blip1_state_dict(flat: Flat, cfg, kind: str) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _eva_into(sd, flat, cfg.vit, "visual_encoder.")
    if kind in ("blip_caption", "blip_vqa"):
        _bert_into(sd, flat, cfg.text, "text_decoder.", "text_decoder.bert.", lm_head=True)
    if kind != "blip_caption":
        _bert_into(sd, flat, cfg.encoder_text, "text_encoder.", "text_encoder.",
                   nlvr=kind == "blip_nlvr")
    heads = {"blip_caption": ("vision_proj", "text_proj"),
             "blip_retrieval": ("vision_proj", "text_proj", "itm_head")}.get(kind, ())
    for head in heads:
        _dense(sd, head, flat, head)
    if kind == "blip_nlvr":
        _dense(sd, "cls_head.0", flat, "cls_head.dense")
        _dense(sd, "cls_head.2", flat, "cls_head.out")
    return sd


@torch.no_grad()
def load_jax_params(model, flat: Flat) -> None:
    """Copy the JAX params into ``model`` in place, casting to each
    parameter's dtype. Every port parameter must be covered exactly, those
    its state dict leaves out too (NLVR's unused merge layers)."""
    sd = jax_to_state_dict({k: np.asarray(a) for k, a in flat.items()}, model.cfg, model)
    own = dict(model.state_dict())
    own.update(unsaved_parameters(model))
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
