"""FlanT5 encoder-decoder (port of ``ecoflap_tpu/models/t5.py``; reference
the vendored HF T5, LAVIS modeling_t5.py): BLIP-2's language model and the
standalone ``t5`` model (``make_adapter``: stacks ``encoder.block`` and
``decoder.block``, the C4 prefix-LM loss over ``input_ids``).

RMSNorm pre-norm blocks, unscaled attention without biases, one relative
position bias table per stack (on block 0, as in HF), gated-gelu FFN
(``wo(gelu(wi_0 x) * wi_1 x)``, exact gelu), untied ``lm_head``, CE that
ignores -100. Submodule names are the HF/reference ones, so sparsity-dict
keys read ``t5_model.encoder.block.3.layer.0.SelfAttention.q.weight``.

The decoder always sees an all-ones self-attention key mask, as HF does with
``decoder_attention_mask=None``: a documented deviation kept on purpose
(PARITY.md, "decoder mask").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.layers import (
    collect_stats,
    embedding,
    linear,
    linear_f32,
    mask_bias,
    rms_norm,
)
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter, StackSpec

ENCODER_LINEARS = (
    "layer.0.SelfAttention.q",
    "layer.0.SelfAttention.k",
    "layer.0.SelfAttention.v",
    "layer.0.SelfAttention.o",
    "layer.1.DenseReluDense.wi_0",
    "layer.1.DenseReluDense.wi_1",
    "layer.1.DenseReluDense.wo",
)
DECODER_LINEARS = (
    "layer.0.SelfAttention.q",
    "layer.0.SelfAttention.k",
    "layer.0.SelfAttention.v",
    "layer.0.SelfAttention.o",
    "layer.1.EncDecAttention.q",
    "layer.1.EncDecAttention.k",
    "layer.1.EncDecAttention.v",
    "layer.1.EncDecAttention.o",
    "layer.2.DenseReluDense.wi_0",
    "layer.2.DenseReluDense.wi_1",
    "layer.2.DenseReluDense.wo",
)


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 32
    rel_buckets: int = 32
    rel_max_distance: int = 128
    ln_eps: float = 1e-6
    pad_token_id: int = 0
    decoder_start_token_id: int = 0
    eos_token_id: int = 1

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


def flan_t5_xl() -> T5Config:
    return T5Config()


def flan_t5_xxl() -> T5Config:
    return T5Config(d_model=4096, d_ff=10240, num_heads=64)


def flan_t5_base() -> T5Config:
    return T5Config(d_model=768, d_ff=2048, num_layers=12,
                    num_decoder_layers=12, num_heads=12)


def tiny_config(**kw) -> T5Config:
    defaults = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_decoder_layers=2, num_heads=4, rel_buckets=8,
                    rel_max_distance=16)
    defaults.update(kw)
    return T5Config(**defaults)


# -- relative position bias ----------------------------------------------------

def relative_position_bucket(rp: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    bucket = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        bucket = bucket + (rp > 0).to(rp.dtype) * num_buckets
        rp = rp.abs()
    else:
        rp = -torch.clamp_max(rp, 0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    # float32 throughout, as jnp does it (t5.py:216-220)
    denom = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32,
                                   device=rp.device))
    large = max_exact + (
        torch.log(rp.to(torch.float32) / max_exact + 1e-9) / denom
        * (num_buckets - max_exact)).to(rp.dtype)
    large = torch.clamp_max(large, num_buckets - 1)
    return bucket + torch.where(is_small, rp, large)


def position_bias(cfg: T5Config, table: torch.Tensor, q_len: int, k_len: int,
                  bidirectional: bool) -> torch.Tensor:
    """(1, H, q_len, k_len) float32 bias from a (buckets, H) table."""
    ctx = torch.arange(q_len, device=table.device)[:, None]
    mem = torch.arange(k_len, device=table.device)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional,
                                       cfg.rel_buckets, cfg.rel_max_distance)
    return table[buckets].permute(2, 0, 1)[None].to(torch.float32)


# -- modules -------------------------------------------------------------------

class T5LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        d, inner = cfg.d_model, cfg.inner_dim
        self.q = nn.Linear(d, inner, bias=False)
        self.k = nn.Linear(d, inner, bias=False)
        self.v = nn.Linear(d, inner, bias=False)
        self.o = nn.Linear(inner, d, bias=False)
        self.relative_attention_bias = (
            nn.Embedding(cfg.rel_buckets, cfg.num_heads) if has_relative_bias
            else None)

    def forward(self, cfg: T5Config, x, kv, bias, stats, prefix, collect):
        """Unscaled attention; scores in the activation dtype (t5.py:247-276)."""
        # one statistic per distinct input: q, k and v share it in
        # self-attention, k and v in cross-attention
        if kv is x:
            collect_stats(stats, (f"{prefix}.q", f"{prefix}.k", f"{prefix}.v"), x,
                          collect)
        else:
            collect_stats(stats, f"{prefix}.q", x, collect)
            collect_stats(stats, (f"{prefix}.k", f"{prefix}.v"), kv, collect)
        b, sq, _ = x.shape
        sk = kv.shape[1]
        h = cfg.num_heads
        qh = linear(x, self.q).reshape(b, sq, h, -1).transpose(1, 2)
        kh = linear(kv, self.k).reshape(b, sk, h, -1).transpose(1, 2)
        vh = linear(kv, self.v).reshape(b, sk, h, -1).transpose(1, 2)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) + bias.to(x.dtype)
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        o = torch.matmul(probs, vh).transpose(1, 2).reshape(b, sq, -1)
        collect_stats(stats, f"{prefix}.o", o, collect)
        return linear(o, self.o)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, stats, prefix, collect):
        collect_stats(stats, (f"{prefix}.wi_0", f"{prefix}.wi_1"), x, collect)
        h = F.gelu(linear(x, self.wi_0)) * linear(x, self.wi_1)
        collect_stats(stats, f"{prefix}.wo", h, collect)
        return linear(h, self.wo)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model)


class T5LayerCrossAttention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.EncDecAttention = T5Attention(cfg, False)
        self.layer_norm = T5LayerNorm(cfg.d_model)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, decoder: bool, has_relative_bias: bool):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = decoder
        layers = [T5LayerSelfAttention(cfg, has_relative_bias)]
        if decoder:
            layers.append(T5LayerCrossAttention(cfg))
        layers.append(T5LayerFF(cfg))
        self.layer = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, cache, collect: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Encoder: cache = self-attention bias. Decoder: cache =
        (self_bias, cross_bias, encoder_hidden_states)."""
        cfg, eps = self.cfg, self.cfg.ln_eps
        stats: Dict[str, torch.Tensor] = {}
        if self.is_decoder:
            self_bias, cross_bias, enc = cache
        else:
            self_bias = cache
        sa = self.layer[0]
        h = rms_norm(x, sa.layer_norm.weight, eps)
        x = x + sa.SelfAttention(cfg, h, h, self_bias, stats,
                                 "layer.0.SelfAttention", collect)
        if self.is_decoder:
            ca = self.layer[1]
            h = rms_norm(x, ca.layer_norm.weight, eps)
            x = x + ca.EncDecAttention(cfg, h, enc.to(h.dtype), cross_bias, stats,
                                       "layer.1.EncDecAttention", collect)
        ff = self.layer[-1]
        h = rms_norm(x, ff.layer_norm.weight, eps)
        x = x + ff.DenseReluDense(h, stats, f"layer.{len(self.layer) - 1}"
                                  ".DenseReluDense", collect)
        return x, stats


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, decoder: bool):
        super().__init__()
        n = cfg.num_decoder_layers if decoder else cfg.num_layers
        self.block = nn.ModuleList(T5Block(cfg, decoder, i == 0) for i in range(n))
        self.final_layer_norm = T5LayerNorm(cfg.d_model)

    @property
    def rel_bias(self) -> torch.Tensor:
        return self.block[0].layer[0].SelfAttention.relative_attention_bias.weight


class T5Model(nn.Module):
    """``T5ForConditionalGeneration``'s parameters: shared, encoder, decoder,
    lm_head."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg, decoder=False)
        self.decoder = T5Stack(cfg, decoder=True)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)

    # -- biases ---------------------------------------------------------------
    def encoder_bias(self, attn_mask: torch.Tensor, q_len: int) -> torch.Tensor:
        pb = position_bias(self.cfg, self.encoder.rel_bias, q_len, q_len, True)
        return pb + mask_bias(attn_mask)

    def decoder_biases(self, dec_mask: torch.Tensor, enc_mask: torch.Tensor,
                       q_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        pb = position_bias(self.cfg, self.decoder.rel_bias, q_len, q_len, False)
        tril = torch.ones(q_len, q_len, dtype=torch.bool, device=pb.device).tril()
        causal = torch.where(tril, 0.0, -1e9).to(torch.float32)[None, None]
        return pb + causal + mask_bias(dec_mask), mask_bias(enc_mask)

    # -- forwards -------------------------------------------------------------
    def encode_embeds(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """Encoder over pre-built input embeddings (the BLIP-2 path)."""
        bias = self.encoder_bias(attn_mask, x.shape[1])
        for blk in self.encoder.block:
            x, _ = blk(x, bias)
        return rms_norm(x, self.encoder.final_layer_norm.weight, self.cfg.ln_eps)

    def encode(self, input_ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        return self.encode_embeds(embedding(input_ids, self.shared), attn_mask)

    def decode(self, enc_out: torch.Tensor, enc_mask: torch.Tensor,
               decoder_input_ids: torch.Tensor,
               decoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced decoder -> (B, S, V) float32 logits (t5.py:387-409)."""
        if decoder_mask is None:
            decoder_mask = torch.ones_like(decoder_input_ids)
        x = embedding(decoder_input_ids, self.shared)
        self_bias, cross_bias = self.decoder_biases(decoder_mask, enc_mask, x.shape[1])
        for blk in self.decoder.block:
            x, _ = blk(x, (self_bias, cross_bias, enc_out))
        return self.logits(x)

    def decoder_inputs(self, labels: torch.Tensor, enc_out: torch.Tensor,
                       enc_mask: torch.Tensor):
        """(x, (self_bias, cross_bias, enc_out)) for the decoder blocks, with
        the all-ones decoder key mask of HF's ``decoder_attention_mask=None``."""
        dec_in = shift_right(self.cfg, labels)
        x = embedding(dec_in, self.shared)
        self_bias, cross_bias = self.decoder_biases(
            torch.ones_like(dec_in), enc_mask, x.shape[1])
        return x, (self_bias, cross_bias, enc_out)

    def logits(self, dec_hidden: torch.Tensor) -> torch.Tensor:
        """Final RMSNorm + lm_head with float32 logits (the JAX dot's
        ``preferred_element_type=float32``: products of the stored values,
        summed in float32, never rounded to the weight dtype)."""
        x = rms_norm(dec_hidden, self.decoder.final_layer_norm.weight,
                     self.cfg.ln_eps)
        return linear_f32(x, self.lm_head, widen=True)

    def loss_from_dec_hidden(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return ce_per_sample(self.logits(x), labels)

    def loss_from_enc(self, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        x, cache = self.decoder_inputs(labels, enc_out, enc_mask)
        for blk in self.decoder.block:
            x, _ = blk(x, cache)
        return self.loss_from_dec_hidden(x, labels)

    def per_sample_loss(self, enc_embeds: torch.Tensor, attn_mask: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
        """(B,) per-sample token-mean CE over pre-built encoder embeddings."""
        enc_out = self.encode_embeds(enc_embeds, attn_mask)
        return self.loss_from_enc(enc_out, attn_mask, labels)

    def text_loss(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
        """(B,) per-sample token-mean CE over input ids: the standalone
        model's calibration loss (t5.py:422-442)."""
        return self.loss_from_enc(self.encode(input_ids, attn_mask), attn_mask, labels)

    def first_token_logits(self, input_ids: torch.Tensor,
                           attn_mask: torch.Tensor) -> torch.Tensor:
        """(B, V) float32 logits of the decoder's first step from
        ``decoder_start_token_id``: what MMLU scores (evaluate.py:549-580)."""
        dec_in = torch.full((input_ids.shape[0], 1), self.cfg.decoder_start_token_id,
                            dtype=input_ids.dtype, device=input_ids.device)
        return self.decode(self.encode(input_ids, attn_mask), attn_mask, dec_in)[:, 0]

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """HF T5 init factors, as the JAX ``init_params`` draws them."""
        cfg = self.cfg
        d, inner, ff = cfg.d_model, cfg.inner_dim, cfg.d_ff
        normal_(self.shared.weight, 1.0, gen)
        for stack in (self.encoder, self.decoder):
            normal_(stack.rel_bias, 0.1, gen)
            stack.final_layer_norm.weight.fill_(1.0)
            for blk in stack.block:
                for sub in blk.layer:
                    sub.layer_norm.weight.fill_(1.0)
                    att = getattr(sub, "SelfAttention", None) or getattr(
                        sub, "EncDecAttention", None)
                    if att is not None:
                        normal_(att.q.weight, (d * inner) ** -0.5, gen)
                        normal_(att.k.weight, d ** -0.5, gen)
                        normal_(att.v.weight, d ** -0.5, gen)
                        normal_(att.o.weight, inner ** -0.5, gen)
                    else:
                        mlp = sub.DenseReluDense
                        normal_(mlp.wi_0.weight, d ** -0.5, gen)
                        normal_(mlp.wi_1.weight, d ** -0.5, gen)
                        normal_(mlp.wo.weight, ff ** -0.5, gen)
        normal_(self.lm_head.weight, d ** -0.5, gen)


def shift_right(cfg: T5Config, labels: torch.Tensor) -> torch.Tensor:
    """HF ``_shift_right``: prepend decoder_start, drop the last token, and
    map -100 to pad."""
    start = torch.full_like(labels[:, :1], cfg.decoder_start_token_id)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, torch.full_like(shifted, cfg.pad_token_id),
                       shifted)


def ce_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, S, V) float32 logits + (B, S) labels, -100 ignored -> (B,)
    token-mean CE in the logsumexp form of t5.py:445-454."""
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return ce.sum(dim=-1) / valid.sum(dim=-1).clamp_min(1).to(ce.dtype)


# -- the standalone model (``t5``, lavis/models/t5_models/t5.py) ----------------

def config_for_scale(scale: str) -> T5Config:
    """The CLIs' ``--model_scale``: ``full`` FlanT5-XL, ``small``
    flan-t5-base, ``tiny`` the test shapes."""
    if scale == "full":
        return flan_t5_xl()
    if scale == "small":
        return flan_t5_base()
    return tiny_config()


def build_model(cfg: T5Config, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> T5Model:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype``, with frozen weights; ``seed`` draws a random init from its own
    ``torch.Generator``, ``seed=None`` leaves the storage for a loader."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = T5Model(cfg).to(dtype)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


def make_adapter(model: T5Model) -> ModelAdapter:
    """The standalone-T5 adapter (t5.py:552-570): the encoder and decoder
    stacks under the HF names, the prefix-LM loss over C4-style
    ``{input_ids, attn_mask, labels}`` batches, both stacks in the submodel
    ``t5``. No suffix plans: MeZO scores every target by the serial in-place
    cycle on the whole loss."""
    cfg = model.cfg

    def enc_prepare(m, batch):
        x = m.shared(batch["input_ids"])
        return x, m.encoder_bias(batch["attn_mask"], x.shape[1])

    def dec_prepare(m, batch):
        enc_out = m.encode(batch["input_ids"], batch["attn_mask"])
        return m.decoder_inputs(batch["labels"], enc_out, batch["attn_mask"])

    def block_forward(block, x, cache, collect=None):
        return block(x, cache, collect=collect)

    stacks = [
        StackSpec("encoder.block", cfg.num_layers, ENCODER_LINEARS, True,
                  enc_prepare, block_forward, lambda m: m.encoder.block),
        StackSpec("decoder.block", cfg.num_decoder_layers, DECODER_LINEARS, True,
                  dec_prepare, block_forward, lambda m: m.decoder.block),
    ]
    return ModelAdapter(
        name="t5", model=model,
        loss_fn=lambda m, batch: m.text_loss(batch["input_ids"], batch["attn_mask"],
                                             batch["labels"]),
        stacks=stacks, model_prefixes={s.name: "t5" for s in stacks})
