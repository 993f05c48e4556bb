"""LLaMA decoder-only LM (port of ``ecoflap_tpu/models/llama.py``; reference
the stock HF ``LlamaForCausalLM`` of ``LLaMA/main.py``).

RMSNorm pre-norm blocks, rotary position embeddings (HF ``rotate_half``),
SwiGLU MLP (``down(silu(gate x) * (up x))``), separate q/k/v/o projections,
no biases, untied ``lm_head``. Parameter names are HF's, so sparsity-dict
keys read ``model.layers.{i}.self_attn.q_proj.weight``; masks are per row.

Attention goes through ``ops.attention.mha`` with ``bias=None`` and
``causal=True`` whenever there is no padding mask (every calibration
window), so a bf16 model on the card runs the flash kernel
(``csrc/flash_attn.cu``). The rotary tables are (1, 1, S, Dh): broadcast
ready, and of a shape the microbatch slicer never cuts (a leading dimension
of 1 is only cut when the whole batch is one sample, where the cut is the
identity).

bf16 differs from the JAX package in one place: the roped q and k are
rounded back to the activation dtype (the kernel takes bf16 operands, and HF
rounds them too), where the JAX package promotes them to float32. In
float32 the two are the same computation.
"""

from __future__ import annotations

import math
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
from ecoflap_tpu_torch.ops.attention import mha
from ecoflap_tpu_torch.parallel.mesh import dp_size, dp_slice, dp_split, dp_sum_
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter, StackSpec

LINEAR_NAMES = (
    "self_attn.q_proj",
    "self_attn.k_proj",
    "self_attn.v_proj",
    "self_attn.o_proj",
    "mlp.gate_proj",
    "mlp.up_proj",
    "mlp.down_proj",
)
# the JAX package's stacked-parameter paths of each linear
LOCAL_TO_PATH = {
    "self_attn.q_proj": "attn.q",
    "self_attn.k_proj": "attn.k",
    "self_attn.v_proj": "attn.v",
    "self_attn.o_proj": "attn.o",
    "mlp.gate_proj": "mlp.gate",
    "mlp.up_proj": "mlp.up",
    "mlp.down_proj": "mlp.down",
}

Cache = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    d_ff: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    max_seq_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def llama_7b() -> LlamaConfig:
    return LlamaConfig()


def llama_13b() -> LlamaConfig:
    return LlamaConfig(d_model=5120, num_layers=40, num_heads=40,
                       num_kv_heads=40, d_ff=13824)


def open_llama_3b() -> LlamaConfig:
    return LlamaConfig(d_model=3200, num_layers=26, num_heads=32,
                       num_kv_heads=32, d_ff=8640)


def tiny_config(**kw) -> LlamaConfig:
    defaults = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4,
                    num_kv_heads=4, d_ff=64, max_seq_len=32)
    defaults.update(kw)
    return LlamaConfig(**defaults)


# -- RoPE ----------------------------------------------------------------------

def rope_cos_sin(cfg: LlamaConfig, seq_len: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (1, 1, S, Dh) cos and sin tables (llama.py:135-143)."""
    dh = cfg.head_dim
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    inv_freq = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                            device=device), exps)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos()[None, None], emb.sin()[None, None]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, Dh); HF rotate_half convention, float32 tables, one
    rounding to x's dtype."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


# -- modules -------------------------------------------------------------------

class LlamaRMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, kv = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, kv, bias=False)
        self.v_proj = nn.Linear(d, kv, bias=False)
        self.o_proj = nn.Linear(d, d, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.up_proj = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.down_proj = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class LlamaBlock(nn.Module):
    """One decoder layer; ``forward`` is ``block_forward`` (llama.py:158-204)
    with the Wanda statistics folded in when ``collect="wanda"``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = LlamaAttention(cfg)
        self.mlp = LlamaMLP(cfg)
        self.input_layernorm = LlamaRMSNorm(cfg.d_model, cfg.rms_eps)
        self.post_attention_layernorm = LlamaRMSNorm(cfg.d_model, cfg.rms_eps)

    def forward(self, x: torch.Tensor, cache: Cache, collect: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """cache = (attn_bias, cos, sin), shared by every block."""
        bias, cos, sin = cache
        cfg = self.cfg
        stats: Dict[str, torch.Tensor] = {}
        b, s, _ = x.shape
        h_n, kv_n, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        attn, mlp = self.self_attn, self.mlp

        h = self.input_layernorm(x)
        collect_stats(stats, ("self_attn.q_proj", "self_attn.k_proj",
                              "self_attn.v_proj"), h, collect)
        qh = linear(h, attn.q_proj).view(b, s, h_n, dh).transpose(1, 2)
        kh = linear(h, attn.k_proj).view(b, s, kv_n, dh).transpose(1, 2)
        vh = linear(h, attn.v_proj).view(b, s, kv_n, dh).transpose(1, 2)
        qh = apply_rope(qh, cos, sin)
        kh = apply_rope(kh, cos, sin)
        if kv_n != h_n:  # grouped-query attention
            kh = kh.repeat_interleave(h_n // kv_n, dim=1)
            vh = vh.repeat_interleave(h_n // kv_n, dim=1)
        # bias None = pure causal (calibration windows): flash-eligible. With
        # a padding mask the causal + padding bias rides in (prepare_cache)
        o = mha(qh, kh, vh, sm_scale=dh ** -0.5, bias=bias, causal=bias is None)
        o = o.transpose(1, 2).reshape(b, s, h_n * dh).to(x.dtype)
        collect_stats(stats, "self_attn.o_proj", o, collect)
        x = x + linear(o, attn.o_proj)

        h = self.post_attention_layernorm(x)
        collect_stats(stats, ("mlp.gate_proj", "mlp.up_proj"), h, collect)
        hh = F.silu(linear(h, mlp.gate_proj)) * linear(h, mlp.up_proj)
        collect_stats(stats, "mlp.down_proj", hh, collect)
        return x + linear(hh, mlp.down_proj), stats


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.num_layers))
        self.norm = LlamaRMSNorm(cfg.d_model, cfg.rms_eps)


def next_token_ce(logits: torch.Tensor, input_ids: torch.Tensor,
                  attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B,) next-token CE, mean over valid targets, in the logsumexp form
    (llama.py:242-258): no second (B, S, V) log-softmax array."""
    targets = input_ids[:, 1:]
    valid = (torch.ones_like(targets, dtype=torch.bool) if attn_mask is None
             else attn_mask[:, 1:] > 0)
    shifted = logits[:, :-1]
    lse = torch.logsumexp(shifted, dim=-1)
    picked = torch.gather(shifted, -1, targets[..., None])[..., 0]
    ce = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return ce.sum(dim=-1) / valid.sum(dim=-1).clamp_min(1).to(ce.dtype)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)

    def prepare_cache(self, attn_mask: Optional[torch.Tensor], seq_len: int,
                      device) -> Cache:
        """No mask: bias None and pure-causal attention (flash-eligible, no
        (S, S) buffer). With a padding mask the causal + padding bias is
        built here, (B, 1, S, S), and causality comes from it."""
        if attn_mask is None:
            bias = None
        else:
            tril = torch.ones(seq_len, seq_len, dtype=torch.bool, device=device).tril()
            causal = torch.where(tril, 0.0, -1e9).to(torch.float32)[None, None]
            bias = causal + mask_bias(attn_mask)
        cos, sin = rope_cos_sin(self.cfg, seq_len, device)
        return bias, cos, sin

    def forward(self, input_ids: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) ids -> (B, S, V) float32 logits."""
        x = embedding(input_ids, self.model.embed_tokens)
        cache = self.prepare_cache(attn_mask, x.shape[1], x.device)
        for blk in self.model.layers:
            x, _ = blk(x, cache)
        return linear_f32(self.model.norm(x), self.lm_head)

    def per_sample_loss(self, input_ids: torch.Tensor,
                        attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return next_token_ce(self(input_ids, attn_mask), input_ids, attn_mask)

    def loss_from_hidden(self, x: torch.Tensor, input_ids: torch.Tensor,
                         attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """per_sample_loss from the layer stack's output: the suffix-plan
        finish (llama.py:272-285)."""
        logits = linear_f32(self.model.norm(x), self.lm_head)
        return next_token_ce(logits, input_ids, attn_mask)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """The JAX init's distributions (llama.py:89-128), from ``gen``."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        normal_(self.model.embed_tokens.weight, 0.02, gen)
        for blk in self.model.layers:
            for lin in (blk.self_attn.q_proj, blk.self_attn.k_proj,
                        blk.self_attn.v_proj, blk.self_attn.o_proj,
                        blk.mlp.gate_proj, blk.mlp.up_proj):
                normal_(lin.weight, d ** -0.5, gen)
            normal_(blk.mlp.down_proj.weight, f ** -0.5, gen)
            blk.input_layernorm.weight.fill_(1.0)
            blk.post_attention_layernorm.weight.fill_(1.0)
        self.model.norm.weight.fill_(1.0)
        normal_(self.lm_head.weight, d ** -0.5, gen)


@torch.no_grad()
def perplexity(model: LlamaForCausalLM, token_stream: torch.Tensor,
               seqlen: int = 2048, batch_size: int = 1) -> float:
    """WikiText-2-style perplexity: non-overlapping windows of ``seqlen``
    over one token stream, token-weighted mean NLL (llama.py:288-301).
    Under a mesh each dp rank takes its slice of every batch of windows, and
    the NLL sums and token counts are all-reduced over dp (a batch that dp
    does not divide is evaluated whole on every rank and not reduced)."""
    n = token_stream.shape[0] // seqlen
    windows = token_stream[: n * seqlen].reshape(n, seqlen)
    nll, tokens = 0.0, 0
    cut = torch.zeros(2, dtype=torch.float64, device=token_stream.device)
    for i in range(0, n, batch_size):
        w = windows[i:i + batch_size]
        local = dp_slice(w, w.shape[0])
        s = float(model.per_sample_loss(local).sum()) * seqlen
        if dp_split(w.shape[0]):  # (NLL sum, token count) of this rank's slice
            cut += torch.tensor([s, local.shape[0] * seqlen], dtype=torch.float64,
                                device=cut.device)
        else:
            nll += s
            tokens += w.shape[0] * seqlen
    if dp_size() > 1:
        cut_nll, cut_tokens = dp_sum_(cut).tolist()
        nll, tokens = nll + cut_nll, tokens + int(cut_tokens)
    return math.exp(nll / tokens)


def config_for_scale(scale: str) -> LlamaConfig:
    """The CLIs' ``--model_scale``: ``full`` LLaMA-7B, ``small``
    OpenLLaMA-3B, ``tiny`` the test shapes."""
    if scale == "full":
        return llama_7b()
    if scale == "small":
        return open_llama_3b()
    return tiny_config()


def build_model(cfg: LlamaConfig, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> LlamaForCausalLM:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype``, with frozen weights. ``seed`` draws a random init from its own
    ``torch.Generator``; ``seed=None`` leaves the storage uninitialised for a
    loader to fill."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg).to(dtype)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


# -- pruning adapter -----------------------------------------------------------

def make_adapter(model: LlamaForCausalLM) -> ModelAdapter:
    """One stack, ``model.layers``, per-row masks, and its suffix plan
    (llama.py:308-349)."""
    cfg = model.cfg

    def prepare_inputs(m, batch):
        x = embedding(batch["input_ids"], m.model.embed_tokens)
        return x, m.prepare_cache(batch.get("attn_mask"), x.shape[1], x.device)

    def block_forward(block, x, cache, collect=None):
        return block(x, cache, collect=collect)

    stack = StackSpec("model.layers", cfg.num_layers, LINEAR_NAMES, True,
                      prepare_inputs, block_forward, lambda m: m.model.layers)

    def build_mezo_plans(m, batch):
        from ecoflap_tpu_torch.pruning.plans import SuffixPlan

        def finish(mm, y, d):
            return mm.loss_from_hidden(y, d["input_ids"], d.get("attn_mask"))

        keys = [k for k in ("input_ids", "attn_mask") if k in batch]
        # the serial cycle by default: a block's suffix over 2048-token
        # windows is compute-bound at one lane, so stacking seven lanes saves
        # no time and holds their activations (PERF.md). Asked for, the lane
        # ensemble finishes lane by lane: one lane's float32 logits at
        # LLaMA-7B's 8 windows of 2048 are 2.1 GB, seven lanes' 14.7 GB
        return [SuffixPlan(stack, finish, m, batch, batch_keys=keys,
                           lanes=False, finish_lanes=1)]

    return ModelAdapter(
        name="llama",
        model=model,
        loss_fn=lambda m, batch: m.per_sample_loss(batch["input_ids"],
                                                   batch.get("attn_mask")),
        stacks=[stack],
        build_mezo_plans=build_mezo_plans,
        model_prefixes={stack.name: "model"},
    )
