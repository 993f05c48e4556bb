"""LFM2-MoE, the hybrid short-convolution / attention decoder LM with sparse
experts (LiquidAI LFM2-8B-A1B; HF ``Lfm2MoeForCausalLM``).

Every layer is a pre-norm residual pair: an operator (``operator_norm``,
then a gated short convolution or grouped-query attention) and a feed-forward
part (``ffn_norm``, then a dense SwiGLU in the first ``num_dense_layers``
layers and a sparse mixture of SwiGLU experts after them). RMSNorm
everywhere, no biases, embeddings tied to the output head.

* Short convolution (``conv``): ``in_proj`` d -> 3d splits into B, C and x;
  the layer computes a depthwise causal conv1d of B*x with a kernel of
  ``conv_L_cache`` taps, multiplies by C and applies ``out_proj``.
* Attention (``self_attn``): separate q/k/v projections, RMSNorm on each
  head's q and k (``q_layernorm``, ``k_layernorm``) before RoPE (HF
  ``rotate_half``), ``num_key_value_heads`` shared KV heads, ``out_proj``.
  It goes through ``ops.attention.mha``; at head dim 64 no shape is
  flash-eligible, so windows of 1024 and more take the chunked path.
* Sparse layer (``feed_forward``): a linear router ``gate`` (d -> experts)
  with a sigmoid; the top ``num_experts_per_tok`` of sigmoid + ``expert_bias``
  are chosen, and their un-biased sigmoids, normalised to sum 1 (HF adds
  1e-6 to the sum), weight their outputs. Each expert runs only on
  the tokens routed to it (``SparseMoe.forward``): the assignments are
  sorted by expert once, their counts read back once (the layer's one
  host synchronise), and each expert gathers its tokens, runs its SwiGLU
  and adds its weighted output into a float32 sum.

The router runs in float32 (bf16 operands, float32 products and sigmoid,
a float32 ``expert_bias``): in bf16 the 32 sigmoids near 0.5 tie often, and
which expert a tie picks would then follow the kernel's order.

Parameter names are HF's (``model.layers.{i}.conv.in_proj``,
``.self_attn.q_proj``, ``.feed_forward.experts.{e}.w1``, ``.feed_forward.gate``,
``model.embedding_norm`` the final norm), so sparsity-dict keys read
``model.layers.{i}.feed_forward.experts.{e}.w2.weight``. Wanda prunes the
blocks' projection linears, the experts' included, per row, as the LLaMA
recipe does; the router, the depthwise conv kernel and the tied embedding
are not targets. An expert's Wanda statistics are folded over the tokens
routed to it only (an expert no token reached gets zeros).

Spans and counters (``utils/profiling.py``): each sparse layer's router,
dispatch, experts and combine are the span ``ecoflap.model.moe``; the counter
``ecoflap.model.moe.expert_calls`` adds the experts that received a token in
that call, ``ecoflap.model.moe.idle_experts`` those that received none.
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
    logits_f32,
    rms_norm,
)
from ecoflap_tpu_torch.models.llama import apply_rope, next_token_ce, rope_cos_sin
from ecoflap_tpu_torch.ops.attention import mha
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter, StackSpec
from ecoflap_tpu_torch.utils.profiling import count, span

ATTN, CONV = "full_attention", "conv"
CONV_LINEARS = ("conv.in_proj", "conv.out_proj")
ATTN_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.out_proj")
MLP_LINEARS = ("w1", "w3", "w2")

Cache = Tuple[torch.Tensor, torch.Tensor]  # the rotary tables, (1, 1, S, Dh)

LFM2_8B_A1B_LAYER_TYPES = (
    CONV, CONV, ATTN, CONV, CONV, CONV, ATTN, CONV, CONV, CONV, ATTN, CONV,
    CONV, CONV, ATTN, CONV, CONV, CONV, ATTN, CONV, CONV, ATTN, CONV, CONV)


# config.json keys that every published LFM2-MoE config sets so, and that the
# model takes as given: no conv bias, selection by sigmoid + expert_bias,
# top-k weights normalised to sum 1 and not scaled
FIXED = {"conv_bias": False, "use_expert_bias": True, "norm_topk_prob": True,
         "routed_scaling_factor": 1}


@dataclass(frozen=True)
class Lfm2MoeConfig:
    """The HF ``config.json`` keys, LFM2-8B-A1B's values by default."""

    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: Tuple[str, ...] = LFM2_8B_A1B_LAYER_TYPES
    num_dense_layers: int = 2
    num_experts: int = 32
    num_experts_per_tok: int = 4
    conv_L_cache: int = 3
    norm_eps: float = 1e-5
    rope_theta: float = 1e6

    def __post_init__(self) -> None:
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"{self.num_hidden_layers} layers")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def sparse(self, i: int) -> bool:
        return i >= self.num_dense_layers

    @classmethod
    def from_dict(cls, d: Dict) -> "Lfm2MoeConfig":
        """From a ``config.json``-style dict (other keys ignored; a nested
        ``rope_parameters`` gives ``rope_theta``). The keys of ``FIXED`` may
        only hold the values the model is written for."""
        for k, v in FIXED.items():
            if k in d and d[k] != v:
                raise ValueError(f"{k}={d[k]!r}: lfm2_moe is written for {k}={v!r}")
        kw = {k: d[k] for k in cls.__dataclass_fields__ if k in d}
        if "rope_theta" not in kw and "rope_parameters" in d:
            kw["rope_theta"] = d["rope_parameters"]["rope_theta"]
        if "layer_types" in kw:
            kw["layer_types"] = tuple(kw["layer_types"])
        return cls(**kw)


def lfm2_8b_a1b() -> Lfm2MoeConfig:
    return Lfm2MoeConfig()


def tiny_config(**kw) -> Lfm2MoeConfig:
    """The CPU tests' shapes: every kind of block, 4 experts top-2."""
    defaults = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=48, num_hidden_layers=6,
                    num_attention_heads=4, num_key_value_heads=2,
                    layer_types=(CONV, CONV, ATTN, CONV, ATTN, CONV),
                    num_dense_layers=2, num_experts=4, num_experts_per_tok=2)
    defaults.update(kw)
    return Lfm2MoeConfig(**defaults)


def config_for_scale(scale: str) -> Lfm2MoeConfig:
    """The CLIs' ``--model_scale``: ``full`` LFM2-8B-A1B, ``tiny`` the test
    shapes."""
    if scale == "full":
        return lfm2_8b_a1b()
    if scale == "tiny":
        return tiny_config()
    raise SystemExit(f"--model_scale {scale}: lfm2_moe has full and tiny")


def block_linears(cfg: Lfm2MoeConfig, i: int) -> Tuple[str, ...]:
    """Block ``i``'s prunable linears: its operator's projections, then its
    dense SwiGLU's or every expert's (w1, w3, w2)."""
    op = ATTN_LINEARS if cfg.layer_types[i] == ATTN else CONV_LINEARS
    if not cfg.sparse(i):
        return op + tuple(f"feed_forward.{n}" for n in MLP_LINEARS)
    return op + tuple(f"feed_forward.experts.{e}.{n}" for e in range(cfg.num_experts)
                      for n in MLP_LINEARS)


# -- modules -------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class ShortConv(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig):
        super().__init__()
        d = cfg.hidden_size
        self.in_proj = nn.Linear(d, 3 * d, bias=False)
        # HF's nn.Conv1d(d, d, L, groups=d): weight (d, 1, L)
        self.conv = nn.Conv1d(d, d, cfg.conv_L_cache, groups=d, bias=False)
        self.out_proj = nn.Linear(d, d, bias=False)

    def forward(self, h: torch.Tensor, stats, collect) -> torch.Tensor:
        s, taps = h.shape[1], self.conv.weight.shape[-1]
        collect_stats(stats, "conv.in_proj", h, collect)
        b, c, x = linear(h, self.in_proj).chunk(3, dim=-1)
        # causal: padded by taps - 1 on both sides, the first S outputs kept
        y = F.conv1d((b * x).transpose(1, 2), self.conv.weight, padding=taps - 1,
                     groups=self.conv.weight.shape[0])[..., :s]
        y = c * y.transpose(1, 2)
        collect_stats(stats, "conv.out_proj", y, collect)
        return linear(y, self.out_proj)


class Attention(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig):
        super().__init__()
        self.cfg = cfg
        d, dh = cfg.hidden_size, cfg.head_dim
        kv = cfg.num_key_value_heads * dh
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * dh, bias=False)
        self.k_proj = nn.Linear(d, kv, bias=False)
        self.v_proj = nn.Linear(d, kv, bias=False)
        self.out_proj = nn.Linear(cfg.num_attention_heads * dh, d, bias=False)
        self.q_layernorm = RMSNorm(dh, cfg.norm_eps)
        self.k_layernorm = RMSNorm(dh, cfg.norm_eps)

    def forward(self, h: torch.Tensor, cache: Cache, stats, collect) -> torch.Tensor:
        cos, sin = cache
        cfg = self.cfg
        b, s, _ = h.shape
        h_n, kv_n, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        collect_stats(stats, ("self_attn.q_proj", "self_attn.k_proj",
                              "self_attn.v_proj"), h, collect)
        qh = self.q_layernorm(linear(h, self.q_proj).view(b, s, h_n, dh)).transpose(1, 2)
        kh = self.k_layernorm(linear(h, self.k_proj).view(b, s, kv_n, dh)).transpose(1, 2)
        vh = linear(h, self.v_proj).view(b, s, kv_n, dh).transpose(1, 2)
        qh, kh = apply_rope(qh, cos, sin), apply_rope(kh, cos, sin)
        if kv_n != h_n:
            kh = kh.repeat_interleave(h_n // kv_n, dim=1)
            vh = vh.repeat_interleave(h_n // kv_n, dim=1)
        o = mha(qh, kh, vh, sm_scale=dh ** -0.5, bias=None, causal=True)
        o = o.transpose(1, 2).reshape(b, s, h_n * dh).to(h.dtype)
        collect_stats(stats, "self_attn.out_proj", o, collect)
        return linear(o, self.out_proj)


class SwiGLU(nn.Module):
    """``w2(silu(w1 x) * w3 x)``."""

    def __init__(self, d: int, f: int):
        super().__init__()
        self.w1 = nn.Linear(d, f, bias=False)
        self.w3 = nn.Linear(d, f, bias=False)
        self.w2 = nn.Linear(f, d, bias=False)

    def forward(self, h: torch.Tensor, stats, collect,
                prefix: str = "feed_forward.") -> torch.Tensor:
        collect_stats(stats, (prefix + "w1", prefix + "w3"), h, collect)
        hh = F.silu(linear(h, self.w1)) * linear(h, self.w3)
        collect_stats(stats, prefix + "w2", hh, collect)
        return linear(hh, self.w2)


class SparseMoe(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = nn.Linear(d, cfg.num_experts, bias=False)
        self.experts = nn.ModuleList(SwiGLU(d, f) for _ in range(cfg.num_experts))
        self.register_buffer("expert_bias", torch.zeros(cfg.num_experts,
                                                        dtype=torch.float32))

    def route(self, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, d) -> the (T, k) chosen experts and their float32 weights."""
        probs = torch.sigmoid(logits_f32(flat, self.gate.weight))
        sel = torch.topk(probs + self.expert_bias, self.cfg.num_experts_per_tok,
                         dim=-1).indices
        wts = probs.gather(1, sel)
        return sel, wts / (wts.sum(dim=-1, keepdim=True) + 1e-6)

    def forward(self, h: torch.Tensor, stats, collect) -> torch.Tensor:
        cfg = self.cfg
        with span("ecoflap.model.moe"):
            flat = h.reshape(-1, h.shape[-1])
            sel, wts = self.route(flat)
            k = cfg.num_experts_per_tok
            by_expert, order = torch.sort(sel.reshape(-1), stable=True)
            counts = torch.bincount(by_expert, minlength=cfg.num_experts).tolist()
            out = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
            start = 0
            for e, n in enumerate(counts):
                prefix = f"feed_forward.experts.{e}."
                if n == 0:
                    if stats is not None and collect is not None:
                        zero_stats(stats, self.experts[e], collect, prefix)
                    if torch.is_grad_enabled():  # its weights get zero gradients
                        ex = self.experts[e]
                        out += 0 * (ex.w1.weight.sum() + ex.w3.weight.sum()
                                    + ex.w2.weight.sum())
                    continue
                pick = order[start:start + n]
                start += n
                tok = pick // k
                y = self.experts[e](flat.index_select(0, tok), stats, collect, prefix)
                out.index_add_(0, tok, y * wts.reshape(-1)[pick, None])
            active = sum(1 for n in counts if n)
            count("ecoflap.model.moe.expert_calls", active)
            count("ecoflap.model.moe.idle_experts", cfg.num_experts - active)
            return out.to(h.dtype).view(h.shape)


def zero_stats(stats: Dict[str, torch.Tensor], expert: SwiGLU, collect: str,
               prefix: str) -> None:
    """An expert no token reached: zero statistics of its linears."""
    for name in MLP_LINEARS:
        w = getattr(expert, name).weight
        cols = w.shape[1]
        shape = (cols,) if collect == "wanda" else (cols, cols)
        stats.setdefault(prefix + name, torch.zeros(shape, dtype=torch.float32,
                                                    device=w.device))


class Block(nn.Module):
    """One decoder layer; ``forward`` folds the Wanda statistics of its
    linears when ``collect="wanda"``."""

    def __init__(self, cfg: Lfm2MoeConfig, i: int):
        super().__init__()
        self.attn = cfg.layer_types[i] == ATTN
        if self.attn:
            self.self_attn = Attention(cfg)
        else:
            self.conv = ShortConv(cfg)
        self.feed_forward = (SparseMoe(cfg) if cfg.sparse(i)
                             else SwiGLU(cfg.hidden_size, cfg.intermediate_size))
        self.operator_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.ffn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)

    def forward(self, x: torch.Tensor, cache: Cache, collect: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        stats: Dict[str, torch.Tensor] = {}
        h = self.operator_norm(x)
        x = x + (self.self_attn(h, cache, stats, collect) if self.attn
                 else self.conv(h, stats, collect))
        return x + self.feed_forward(self.ffn_norm(x), stats, collect), stats


class Lfm2MoeModel(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Block(cfg, i) for i in range(cfg.num_hidden_layers))
        self.embedding_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)


class Lfm2MoeForCausalLM(nn.Module):
    """The output head is the embedding table (tied)."""

    def __init__(self, cfg: Lfm2MoeConfig):
        super().__init__()
        self.cfg = cfg
        self.model = Lfm2MoeModel(cfg)

    def prepare_cache(self, seq_len: int, device) -> Cache:
        return rope_cos_sin(self.cfg, seq_len, device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, V) float32 logits."""
        x = embedding(input_ids, self.model.embed_tokens)
        cache = self.prepare_cache(x.shape[1], x.device)
        for blk in self.model.layers:
            x, _ = blk(x, cache)
        return self.logits(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return linear_f32(self.model.embedding_norm(x), self.model.embed_tokens)

    def per_sample_loss(self, input_ids: torch.Tensor) -> torch.Tensor:
        return next_token_ce(self(input_ids), input_ids, None)

    def loss_from_hidden(self, x: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """per_sample_loss from the layer stack's output: the suffix-plan
        finish."""
        return next_token_ce(self.logits(x), input_ids, None)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Linears N(0, fan_in^-1); the embedding N(0, 0.02^2), as LLaMA's
        init; the depthwise kernels N(0, 1 / taps); norm scales 1;
        ``expert_bias`` N(0, 0.02^2), so that choice by sigmoid + bias
        differs from choice by sigmoid alone."""
        normal_(self.model.embed_tokens.weight, 0.02, gen)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                normal_(m.weight, m.weight.shape[1] ** -0.5, gen)
            elif isinstance(m, nn.Conv1d):
                normal_(m.weight, m.weight.shape[-1] ** -0.5, gen)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, SparseMoe):
                normal_(m.expert_bias, 0.02, gen)


def build_model(cfg: Lfm2MoeConfig, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> Lfm2MoeForCausalLM:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype`` with a float32 ``expert_bias``, frozen. ``seed`` draws a random
    init from its own ``torch.Generator``; ``seed=None`` leaves the storage
    uninitialised (``expert_bias`` zero) for a loader to fill."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Lfm2MoeForCausalLM(cfg).to(dtype)
    model = model.to_empty(device=dev)
    for m in model.modules():
        if isinstance(m, SparseMoe):
            m.expert_bias = torch.zeros(cfg.num_experts, dtype=torch.float32, device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


# -- pruning adapter -----------------------------------------------------------

def make_adapter(model: Lfm2MoeForCausalLM) -> ModelAdapter:
    """One stack, ``model.layers``, per-row masks, each block with its own
    linears (``block_linears``), and a suffix plan for the coarse stage."""
    cfg = model.cfg

    def prepare_inputs(m, batch):
        if batch.get("attn_mask") is not None:
            raise NotImplementedError("lfm2_moe calibrates on whole windows, no padding")
        x = embedding(batch["input_ids"], m.model.embed_tokens)
        return x, m.prepare_cache(x.shape[1], x.device)

    def block_forward(block, x, cache, collect=None):
        return block(x, cache, collect=collect)

    per_block = tuple(block_linears(cfg, i) for i in range(cfg.num_hidden_layers))
    stack = StackSpec("model.layers", cfg.num_hidden_layers, (), True,
                      prepare_inputs, block_forward, lambda m: m.model.layers,
                      block_linears=per_block)

    def build_mezo_plans(m, batch):
        from ecoflap_tpu_torch.pruning.plans import SuffixPlan

        def finish(mm, y, d):
            return mm.loss_from_hidden(y, d["input_ids"])

        # the serial cycle, and lane by lane, as LLaMA's plan: float32 logits
        # of 65,536 words are 0.5 GB a 2048-token window
        return [SuffixPlan(stack, finish, m, batch, batch_keys=["input_ids"],
                           lanes=False, finish_lanes=1)]

    return ModelAdapter(
        name="lfm2_moe",
        model=model,
        loss_fn=lambda m, batch: m.per_sample_loss(batch["input_ids"]),
        stacks=[stack],
        build_mezo_plans=build_mezo_plans,
        model_prefixes={stack.name: "model"},
    )
