"""The BERT stack of BLIP-1's text towers (port of
``ecoflap_tpu/models/bert.py``; reference UPop/models/med.py: BertSelfAttention
:87, BertLayer :322, BertLMHeadModel).

Post-LN BERT with optional cross-attention on every layer (BLIP's text
towers set ``add_cross_attention`` globally), causal masking and an LM head
for the caption decoder, word and position embeddings with LayerNorm. The
modules carry the reference names, so a tower's state dict is the UPop
checkpoint's (``embeddings.word_embeddings``, ``encoder.layer.{i}.attention
.self.query``, ``cls.predictions.transform.dense`` ...), and the prunable
linears are ``LINEAR_NAMES`` under ``encoder.layer.{i}``. The LM head's
decoder is tied to the word embedding and its bias to ``predictions.bias``,
as HF ties them.

Attention goes through ``layers.attention`` (``ops.attention.mha``, naive):
BERT always passes a mask bias, so flash is never eligible, as in the JAX
package. The decode step over a self and cross K/V cache lives in
``models/generation.py`` (``bert_generate``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.layers import (
    attention,
    collect_stats,
    dense,
    gelu,
    layer_norm,
    mask_bias,
)
from ecoflap_tpu_torch.pruning.adapter import StackSpec

LINEAR_NAMES = (
    "attention.self.query",
    "attention.self.key",
    "attention.self.value",
    "attention.output.dense",
    "crossattention.self.query",
    "crossattention.self.key",
    "crossattention.self.value",
    "crossattention.output.dense",
    "intermediate.dense",
    "output.dense",
)
LINEAR_NAMES_NO_CROSS = tuple(n for n in LINEAR_NAMES
                              if not n.startswith("crossattention"))


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30524  # BLIP's bert-base + special tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    encoder_width: int = 768  # cross-attention K/V input width
    add_cross_attention: bool = False
    causal: bool = False  # decoder mode
    ln_eps: float = 1e-12
    pad_token_id: int = 0  # [PAD]
    sep_token_id: int = 102  # [SEP], BLIP's caption EOS


def tiny_config(**kw) -> BertConfig:
    # [SEP] inside the tiny vocab, as the JAX package sets it
    defaults = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_position=32, encoder_width=32,
                    sep_token_id=5)
    defaults.update(kw)
    return BertConfig(**defaults)


class BertSelfAttention(nn.Module):
    def __init__(self, d: int, kv_width: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(kv_width, d)
        self.value = nn.Linear(kv_width, d)


class BertSelfOutput(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class BertAttention(nn.Module):
    def __init__(self, d: int, kv_width: int, eps: float):
        super().__init__()
        self.self = BertSelfAttention(d, kv_width)
        self.output = BertSelfOutput(d, eps)

    def forward(self, x, kv, bias, num_heads, eps, prefix, stats, collect):
        """Post-LN attention (bert.py:_bert_attn): LN(out(attn(q, k, v)) + x)."""
        s = self.self
        collect_stats(stats, f"{prefix}.self.query", x, collect)
        collect_stats(stats, (f"{prefix}.self.key", f"{prefix}.self.value"), kv, collect)
        o = attention(F.linear(x, s.query.weight, s.query.bias),
                      F.linear(kv, s.key.weight, s.key.bias),
                      F.linear(kv, s.value.weight, s.value.bias), num_heads, bias=bias)
        o = dense(self.output.dense, o, name=f"{prefix}.output.dense", stats=stats,
                  collect=collect)
        ln = self.output.LayerNorm
        return layer_norm(o + x, ln.weight, ln.bias, eps)


class BertIntermediate(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.dense = nn.Linear(d, ff)


class BertOutput(nn.Module):
    def __init__(self, ff: int, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(ff, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, index: int = 0):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.attention = BertAttention(d, d, cfg.ln_eps)
        if cfg.add_cross_attention:
            self.crossattention = BertAttention(d, cfg.encoder_width, cfg.ln_eps)
        self.intermediate = BertIntermediate(d, cfg.intermediate_size)
        self.output = BertOutput(cfg.intermediate_size, d, cfg.ln_eps)

    def ffn(self, x, stats, collect):
        h = gelu(dense(self.intermediate.dense, x, name="intermediate.dense", stats=stats,
                       collect=collect), approximate=False)
        h = dense(self.output.dense, h, name="output.dense", stats=stats, collect=collect)
        ln = self.output.LayerNorm
        return layer_norm(h + x, ln.weight, ln.bias, self.cfg.ln_eps)

    def forward(self, x: torch.Tensor, cache: Any, collect: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``cache`` = (self bias, cross bias, encoder states); no encoder
        states skip the cross-attention (a text-only pass)."""
        self_bias, cross_bias, enc = cache
        cfg = self.cfg
        stats: Dict[str, torch.Tensor] = {}
        x = self.attention(x, x, self_bias, cfg.num_heads, cfg.ln_eps, "attention",
                           stats, collect)
        if enc is not None:
            x = self.crossattention(x, enc.to(x.dtype), cross_bias, cfg.num_heads,
                                    cfg.ln_eps, "crossattention", stats, collect)
        return self.ffn(x, stats, collect), stats


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position, d)
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.ln_eps)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, layer_cls=BertLayer):
        super().__init__()
        self.layer = nn.ModuleList(layer_cls(cfg, i) for i in range(cfg.num_layers))


def make_cache(cfg: BertConfig, attn_mask: torch.Tensor, enc: Optional[torch.Tensor] = None,
               enc_mask: Optional[torch.Tensor] = None, causal: Optional[bool] = None):
    """(self bias, cross bias, encoder states) of a pass (bert.py:make_cache):
    the mask bias, plus the causal -1e9 above the diagonal in decoder mode;
    the encoder mask's bias, all-ones when none is given."""
    self_bias = mask_bias(attn_mask)
    if cfg.causal if causal is None else causal:
        s = attn_mask.shape[1]
        keep = torch.ones((s, s), dtype=torch.bool, device=attn_mask.device).tril()
        self_bias = self_bias + torch.where(keep, 0.0, -1e9)[None, None]
    cross_bias = None
    if enc is not None:
        if enc_mask is None:
            enc_mask = torch.ones(enc.shape[:2], dtype=torch.long, device=enc.device)
        cross_bias = mask_bias(enc_mask)
    return self_bias, cross_bias, enc


class BertModel(nn.Module):
    """A BERT tower: ``embeddings`` and ``encoder.layer``."""

    def __init__(self, cfg: BertConfig, layer_cls=BertLayer):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg, layer_cls)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        e = self.embeddings
        w = e.word_embeddings.weight
        x = w[ids] + e.position_embeddings.weight[: ids.shape[1]][None].to(w.dtype)
        return layer_norm(x, e.LayerNorm.weight, e.LayerNorm.bias, self.cfg.ln_eps)

    def forward(self, ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                enc: Optional[torch.Tensor] = None, enc_mask: Optional[torch.Tensor] = None,
                causal: Optional[bool] = None) -> torch.Tensor:
        """(B, S) ids -> (B, S, D) hidden states. ``causal`` overrides the
        config's (BLIP's text-only and encoder passes over decoder weights);
        no ``enc`` skips the cross-attention."""
        if attn_mask is None:
            attn_mask = torch.ones_like(ids)
        x = self.embed(ids)
        cache = make_cache(self.cfg, attn_mask, enc, enc_mask, causal)
        for layer in self.encoder.layer:
            x, _ = layer(x, cache)
        return x

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Seeded random init with the JAX ``init_params`` stds: 0.02 normal
        weights and embeddings, zero biases, unit LayerNorms."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, 0.02, gen)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        normal_(self.embeddings.word_embeddings.weight, 0.02, gen)
        normal_(self.embeddings.position_embeddings.weight, 0.02, gen)


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)


class BertLMPredictionHead(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.bias = nn.Parameter(torch.empty(cfg.vocab_size))


class BertOnlyMLMHead(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.predictions = BertLMPredictionHead(cfg)


class BertLMHeadModel(nn.Module):
    """The caption and answer decoder: ``bert`` and the ``cls`` LM head."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.cls = BertOnlyMLMHead(cfg)
        self.tie_weights()

    def tie_weights(self) -> None:
        """The decoder reads the word embedding and ``predictions.bias``
        (med.py BertLMPredictionHead); call again after ``to_empty``."""
        p = self.cls.predictions
        p.decoder.weight = self.bert.embeddings.word_embeddings.weight
        p.decoder.bias = p.bias

    def forward(self, ids, attn_mask=None, enc=None, enc_mask=None, causal=None):
        return self.bert(ids, attn_mask, enc, enc_mask, causal)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(.., D) -> (.., V) float32 (bert.py:lm_logits): gelu(transform),
        LayerNorm, the tied word embedding plus the decoder bias."""
        t = self.cls.predictions.transform
        h = gelu(F.linear(hidden, t.dense.weight, t.dense.bias), approximate=False)
        h = layer_norm(h, t.LayerNorm.weight, t.LayerNorm.bias, self.cfg.ln_eps)
        return (widened_linear(h, self.bert.embeddings.word_embeddings.weight)
                + self.cls.predictions.bias.to(torch.float32))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.bert.init_(gen)
        t = self.cls.predictions.transform
        normal_(t.dense.weight, 0.02, gen)
        t.dense.bias.zero_()
        t.LayerNorm.weight.fill_(1.0)
        t.LayerNorm.bias.zero_()
        self.cls.predictions.bias.zero_()


def widened_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x W^T with float32 output from both operands widened: a product of
    two bf16 values is exact in float32, so this is the JAX dot with
    ``preferred_element_type=float32``, and autograd differentiates the
    weight too (the masked fine-tune trains the tied embedding and the
    heads; ``layers.logits_f32``'s card path takes no weight gradient)."""
    return F.linear(x.to(torch.float32), w.to(torch.float32))


def _block_forward(block, x, cache, collect=None):
    return block(x, cache, collect=collect)


def make_bert_stack(cfg: BertConfig, name: str, blocks, prepare_inputs,
                    linear_names=None) -> StackSpec:
    """The pruning stack of a BERT tower (bert.py:make_bert_stack): per-row
    masks, the reference linear names, ``blocks(model)`` its layers."""
    if linear_names is None:
        linear_names = LINEAR_NAMES if cfg.add_cross_attention else LINEAR_NAMES_NO_CROSS
    return StackSpec(name, cfg.num_layers, linear_names, True, prepare_inputs,
                     _block_forward, blocks)
