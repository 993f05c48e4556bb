"""Plain BLIP-2 FlanT5 (LAVIS ``blip2_t5``): EVA ViT-g -> ln_vision ->
Q-Former -> t5_proj -> FlanT5 over [query embeds ; text embeds], and the
per-sample LM loss that calibrates ECoFLaP.

Written from the published architecture (LAVIS eva_vit.py, Qformer.py,
blip2_t5.py, HF modeling_t5.py) in float32 (or the control's precision,
``numerics.Prec``), one block at a time, with no cache, kernel or batching.
Weights are read by their LAVIS state-dict names from a plain dict. Each
block function can fold its linears' input statistics into ``stats``: the
sum of x^2 per input column (``"wanda"``) or the Gram matrix X^T X
(``"hessian"``), under the linear's name inside the block.

Departures from LAVIS, each the same as the configuration states: the
decoder's self-attention sees an all-ones key mask (HF with
``decoder_attention_mask=None``); images arrive NHWC.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.numerics import (
    Prec,
    attention,
    extract_patches,
    layer_norm,
    mask_bias,
    rms_norm,
)

VIT = "visual_encoder.blocks"
ENC = "t5_model.encoder.block"
DEC = "t5_model.decoder.block"
VIT_LINEARS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
ENC_LINEARS = ("layer.0.SelfAttention.q", "layer.0.SelfAttention.k",
               "layer.0.SelfAttention.v", "layer.0.SelfAttention.o",
               "layer.1.DenseReluDense.wi_0", "layer.1.DenseReluDense.wi_1",
               "layer.1.DenseReluDense.wo")
DEC_LINEARS = ("layer.0.SelfAttention.q", "layer.0.SelfAttention.k",
               "layer.0.SelfAttention.v", "layer.0.SelfAttention.o",
               "layer.1.EncDecAttention.q", "layer.1.EncDecAttention.k",
               "layer.1.EncDecAttention.v", "layer.1.EncDecAttention.o",
               "layer.2.DenseReluDense.wi_0", "layer.2.DenseReluDense.wi_1",
               "layer.2.DenseReluDense.wo")
STACK_LINEARS = {VIT: VIT_LINEARS, ENC: ENC_LINEARS, DEC: DEC_LINEARS}
# T5 prunes row by row, the ViT over the whole tensor (wanda_pruner.py)
PER_ROW = {VIT: False, ENC: True, DEC: True}


def depth(cfg: Dict, stack: str) -> int:
    return {VIT: cfg["vit"]["depth"], ENC: cfg["t5"]["num_layers"],
            DEC: cfg["t5"]["num_decoder_layers"]}[stack]


def collect(stats, names, x, mode):
    if stats is None or mode is None:
        return
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    part = flat.square().sum(dim=0) if mode == "wanda" else flat.T @ flat
    for n in ((names,) if isinstance(names, str) else names):
        stats[n] = stats[n] + part if n in stats else part


# -- EVA ViT-g ---------------------------------------------------------------

def vit_embed(P, v, p: Prec, images, root="visual_encoder"):
    """Patch embedding, cls token and position embedding; ``v`` is the
    tower's sizes, ``root`` its state-dict prefix."""
    w = P[f"{root}.patch_embed.proj.weight"]
    x = p.linear(extract_patches(images.to(torch.float32), v["patch_size"]),
                 w.reshape(w.shape[0], -1), P[f"{root}.patch_embed.proj.bias"])
    cls = P[f"{root}.cls_token"].to(torch.float32).expand(x.shape[0], 1, -1)
    return torch.cat([cls, x], dim=1) + P[f"{root}.pos_embed"].to(torch.float32)


def vit_block(P, v, p: Prec, i, x, stats=None, mode=None, root="visual_encoder"):
    """One pre-LN EVA block: fused qkv with q and v biases, tanh GELU MLP."""
    pre = f"{root}.blocks.{i}."
    eps = v["ln_eps"]
    h = layer_norm(x, P[pre + "norm1.weight"], P[pre + "norm1.bias"], eps)
    collect(stats, "attn.qkv", h, mode)
    qb, vb = P[pre + "attn.q_bias"], P[pre + "attn.v_bias"]
    qkv = p.linear(h, P[pre + "attn.qkv.weight"], torch.cat([qb, torch.zeros_like(qb), vb]))
    q, k, vv = qkv.chunk(3, dim=-1)
    heads = v["num_heads"]
    o = attention(p, q, k, vv, heads, (v["embed_dim"] // heads) ** -0.5)
    collect(stats, "attn.proj", o, mode)
    x = x + p.linear(o, P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"])
    h = layer_norm(x, P[pre + "norm2.weight"], P[pre + "norm2.bias"], eps)
    collect(stats, "mlp.fc1", h, mode)
    h = F.gelu(p.linear(h, P[pre + "mlp.fc1.weight"], P[pre + "mlp.fc1.bias"]),
               approximate="tanh")
    collect(stats, "mlp.fc2", h, mode)
    return x + p.linear(h, P[pre + "mlp.fc2.weight"], P[pre + "mlp.fc2.bias"])


def vit(P, v, p: Prec, images, root="visual_encoder"):
    x = vit_embed(P, v, p, images, root)
    for i in range(v["depth"]):
        x = vit_block(P, v, p, i, x, root=root)
    return x


# -- Q-Former (query path) -----------------------------------------------------

def _bert_attention(P, pre, p: Prec, x, kv, heads, eps):
    q = p.linear(x, P[pre + "self.query.weight"], P[pre + "self.query.bias"])
    k = p.linear(kv, P[pre + "self.key.weight"], P[pre + "self.key.bias"])
    v = p.linear(kv, P[pre + "self.value.weight"], P[pre + "self.value.bias"])
    o = attention(p, q, k, v, heads, (q.shape[-1] // heads) ** -0.5)
    o = p.linear(o, P[pre + "output.dense.weight"], P[pre + "output.dense.bias"])
    return layer_norm(o + x, P[pre + "output.LayerNorm.weight"],
                      P[pre + "output.LayerNorm.bias"], eps)


def qformer(P, cfg, p: Prec, image_embeds):
    qc = cfg["qformer"]
    eps, heads = qc["ln_eps"], qc["num_heads"]
    x = P["query_tokens"].to(torch.float32).expand(image_embeds.shape[0], -1, -1)
    x = layer_norm(x, P["Qformer.bert.embeddings.LayerNorm.weight"],
                   P["Qformer.bert.embeddings.LayerNorm.bias"], eps)
    for i in range(qc["num_layers"]):
        pre = f"Qformer.bert.encoder.layer.{i}."
        x = _bert_attention(P, pre + "attention.", p, x, x, heads, eps)
        if i % qc["cross_attention_freq"] == 0:
            x = _bert_attention(P, pre + "crossattention.", p, x, image_embeds, heads, eps)
        h = F.gelu(p.linear(x, P[pre + "intermediate_query.dense.weight"],
                            P[pre + "intermediate_query.dense.bias"]))
        h = p.linear(h, P[pre + "output_query.dense.weight"],
                     P[pre + "output_query.dense.bias"])
        x = layer_norm(h + x, P[pre + "output_query.LayerNorm.weight"],
                       P[pre + "output_query.LayerNorm.bias"], eps)
    return x


def project(P, cfg, p: Prec, feats):
    """ViT tokens -> (B, queries, d_t5) projected query embeddings."""
    feats = layer_norm(feats, P["ln_vision.weight"], P["ln_vision.bias"], 1e-5)
    return p.linear(qformer(P, cfg, p, feats), P["t5_proj.weight"], P["t5_proj.bias"])


# -- FlanT5 --------------------------------------------------------------------

def _bucket(rp, bidirectional, num_buckets, max_distance):
    bucket = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        bucket = bucket + (rp > 0).to(rp.dtype) * num_buckets
        rp = rp.abs()
    else:
        rp = -torch.clamp_max(rp, 0)
    max_exact = num_buckets // 2
    # float32 throughout, the log of the distance ratio too
    denom = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32,
                                   device=rp.device))
    large = max_exact + (torch.log(rp.to(torch.float32) / max_exact + 1e-9) / denom
                         * (num_buckets - max_exact)).to(rp.dtype)
    large = torch.clamp_max(large, num_buckets - 1)
    return bucket + torch.where(rp < max_exact, rp, large)


def position_bias(P, cfg, stack, q_len, k_len, bidirectional):
    t = cfg["t5"]
    table = P[f"{stack}.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    ctx = torch.arange(q_len, device=table.device)[:, None]
    mem = torch.arange(k_len, device=table.device)[None, :]
    b = _bucket(mem - ctx, bidirectional, t["rel_buckets"], t["rel_max_distance"])
    return table[b].permute(2, 0, 1)[None].to(torch.float32)


def _t5_attention(P, pre, cfg, p: Prec, x, kv, bias, stats, mode, local):
    if kv is x:
        collect(stats, (f"{local}.q", f"{local}.k", f"{local}.v"), x, mode)
    else:
        collect(stats, f"{local}.q", x, mode)
        collect(stats, (f"{local}.k", f"{local}.v"), kv, mode)
    q = p.linear(x, P[pre + "q.weight"])
    k = p.linear(kv, P[pre + "k.weight"])
    v = p.linear(kv, P[pre + "v.weight"])
    o = attention(p, q, k, v, cfg["t5"]["num_heads"], 1.0, bias)  # T5: unscaled
    collect(stats, f"{local}.o", o, mode)
    return p.linear(o, P[pre + "o.weight"])


def _t5_ff(P, pre, p: Prec, x, stats, mode, local):
    collect(stats, (f"{local}.wi_0", f"{local}.wi_1"), x, mode)
    h = F.gelu(p.linear(x, P[pre + "wi_0.weight"])) * p.linear(x, P[pre + "wi_1.weight"])
    collect(stats, f"{local}.wo", h, mode)
    return p.linear(h, P[pre + "wo.weight"])


def enc_block(P, cfg, p: Prec, i, x, bias, stats=None, mode=None):
    pre, eps = f"{ENC}.{i}.layer.", cfg["t5"]["ln_eps"]
    h = rms_norm(x, P[pre + "0.layer_norm.weight"], eps)
    x = x + _t5_attention(P, pre + "0.SelfAttention.", cfg, p, h, h, bias, stats, mode,
                          "layer.0.SelfAttention")
    h = rms_norm(x, P[pre + "1.layer_norm.weight"], eps)
    return x + _t5_ff(P, pre + "1.DenseReluDense.", p, h, stats, mode,
                      "layer.1.DenseReluDense")


def dec_block(P, cfg, p: Prec, i, x, cache, stats=None, mode=None):
    self_bias, cross_bias, enc = cache
    pre, eps = f"{DEC}.{i}.layer.", cfg["t5"]["ln_eps"]
    h = rms_norm(x, P[pre + "0.layer_norm.weight"], eps)
    x = x + _t5_attention(P, pre + "0.SelfAttention.", cfg, p, h, h, self_bias, stats,
                          mode, "layer.0.SelfAttention")
    h = rms_norm(x, P[pre + "1.layer_norm.weight"], eps)
    x = x + _t5_attention(P, pre + "1.EncDecAttention.", cfg, p, h, enc, cross_bias,
                          stats, mode, "layer.1.EncDecAttention")
    h = rms_norm(x, P[pre + "2.layer_norm.weight"], eps)
    return x + _t5_ff(P, pre + "2.DenseReluDense.", p, h, stats, mode,
                      "layer.2.DenseReluDense")


def encoder_inputs(P, cfg, p: Prec, query_embeds, batch):
    """[query embeds ; text embeds] and the encoder's self-attention bias."""
    text = P["t5_model.shared.weight"][batch["text_input_ids"]].to(torch.float32)
    x = torch.cat([query_embeds, text], dim=1)
    mask = torch.cat([torch.ones(query_embeds.shape[:2], dtype=batch["text_input_mask"].dtype,
                                 device=x.device), batch["text_input_mask"]], dim=1)
    bias = position_bias(P, cfg, ENC, x.shape[1], x.shape[1], True) + mask_bias(mask)
    return x, bias, mask


def encoder_out(P, cfg, p: Prec, x, bias):
    for i in range(cfg["t5"]["num_layers"]):
        x = enc_block(P, cfg, p, i, x, bias)
    return rms_norm(x, P["t5_model.encoder.final_layer_norm.weight"], cfg["t5"]["ln_eps"])


def decoder_inputs(P, cfg, labels, enc_out, enc_mask):
    """HF ``_shift_right`` of the labels, their embeddings, and the decoder's
    (self bias, cross bias, encoder states)."""
    t = cfg["t5"]
    start = torch.full_like(labels[:, :1], t["decoder_start_token_id"])
    dec_in = torch.cat([start, labels[:, :-1]], dim=1)
    dec_in = torch.where(dec_in == -100, torch.full_like(dec_in, t["pad_token_id"]), dec_in)
    x = P["t5_model.shared.weight"][dec_in].to(torch.float32)
    n = x.shape[1]
    causal = torch.where(torch.ones(n, n, dtype=torch.bool, device=x.device).tril(),
                         0.0, -1e9).to(torch.float32)[None, None]
    self_bias = position_bias(P, cfg, DEC, n, n, False) + causal
    return x, (self_bias, mask_bias(enc_mask), enc_out)


def lm_loss(P, cfg, p: Prec, dec_hidden, labels):
    """(B,) token-mean CE over the labels, -100 ignored."""
    x = rms_norm(dec_hidden, P["t5_model.decoder.final_layer_norm.weight"], cfg["t5"]["ln_eps"])
    logits = p.linear(x, P["t5_model.lm_head.weight"])
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    return ce.sum(dim=-1) / valid.sum(dim=-1).clamp_min(1).to(ce.dtype)


def per_sample_loss(P, cfg, p: Prec, batch) -> torch.Tensor:
    """(B,) calibration loss of BLIP-2 FlanT5 on one microbatch."""
    qe = project(P, cfg, p, vit(P, cfg["vit"], p, batch["image"]))
    x, bias, mask = encoder_inputs(P, cfg, p, qe, batch)
    enc = encoder_out(P, cfg, p, x, bias)
    y, cache = decoder_inputs(P, cfg, batch["labels"], enc, mask)
    for i in range(cfg["t5"]["num_decoder_layers"]):
        y = dec_block(P, cfg, p, i, y, cache)
    return lm_loss(P, cfg, p, y, batch["labels"])


def stack_block(stack: str):
    return {VIT: lambda P, cfg, p, i, x, cache, stats=None, mode=None:
            vit_block(P, cfg["vit"], p, i, x, stats, mode),
            ENC: enc_block, DEC: dec_block}[stack]


def weight_key(stack: str, i: int, local: str) -> str:
    return f"{stack}.{i}.{local}.weight"


def target_names(cfg: Dict, stacks=(VIT, ENC, DEC)):
    """Every prunable weight in the pruner's order: stack, block, linear."""
    return [weight_key(s, i, ln) for s in stacks for i in range(depth(cfg, s))
            for ln in STACK_LINEARS[s]]


def slice_batch(batch: Dict[str, torch.Tensor], lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def stack_inputs(P, cfg, p: Prec, stack: str, mb: Dict[str, torch.Tensor],
                 query_embeds: Optional[torch.Tensor] = None):
    """(x, cache) entering block 0 of ``stack`` for one microbatch, through
    the weights as they are now; ``query_embeds`` skips the ViT and Q-Former
    once their output no longer changes."""
    if stack == VIT:
        return vit_embed(P, cfg["vit"], p, mb["image"]), None
    if query_embeds is None:
        query_embeds = project(P, cfg, p, vit(P, cfg["vit"], p, mb["image"]))
    x, bias, mask = encoder_inputs(P, cfg, p, query_embeds, mb)
    if stack == ENC:
        return x, bias
    return decoder_inputs(P, cfg, mb["labels"], encoder_out(P, cfg, p, x, bias), mask)
