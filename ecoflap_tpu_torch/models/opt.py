"""OPT decoder LM, BLIP-2 OPT's language tower (port of
``ecoflap_tpu/models/opt.py``; reference LAVIS blip2_models/modeling_opt.py,
HF ``OPTForCausalLM``).

Learned position embeddings at HF's offset of 2 (positions from the
attention mask), pre-LN decoder layers (self-attention with q/k/v/out
biases, ReLU FFN ``fc1``/``fc2``), a final LayerNorm and an LM head tied to
``embed_tokens``: the logits are ``x embed_tokensᵀ`` in float32, and the
model has no ``lm_head`` parameter, so its state dict is HF's
``model.decoder.*`` (what ``export_opt`` writes; an HF checkpoint's tied
``lm_head.weight`` is an extra key the loader ignores). Attention is the
naive one with an additive bias (causal -1e9, plus the padding mask), never
the flash kernel.

Generation from a prefix of embeddings (BLIP-2 OPT's query embeds and
prompt): ``OPTCache`` holds every layer's K/V, the prefix prefilled;
``make_opt_step_fn`` is one decode step over all slots with a -1e9 bias on
the empty ones, as the JAX step computes it; ``generate_from_embeds`` runs
``models/generation.py``'s greedy or beam loop with ``tok0`` (the prompt's
last token, fed first) and ``len_offset`` (prompt length - 1: HF's
``cur_len`` counts the prompt for ``min_length``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.generation import (
    GenerateConfig,
    beam_generate,
    expand_for_beams,
    greedy_generate,
)
from ecoflap_tpu_torch.models.layers import (
    attention,
    collect_stats,
    dense,
    embedding,
    layer_norm,
    linear,
    linear_f32,
    mask_bias,
)
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter, StackSpec

LINEAR_NAMES = (
    "self_attn.q_proj",
    "self_attn.k_proj",
    "self_attn.v_proj",
    "self_attn.out_proj",
    "fc1",
    "fc2",
)
# the JAX package's stacked-parameter paths of each linear
LOCAL_TO_PATH = {
    "self_attn.q_proj": "attn.q",
    "self_attn.k_proj": "attn.k",
    "self_attn.v_proj": "attn.v",
    "self_attn.out_proj": "attn.o",
    "fc1": "mlp.fc1",
    "fc2": "mlp.fc2",
}


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    d_model: int = 2560  # opt-2.7b
    num_layers: int = 32
    num_heads: int = 32
    d_ff: int = 10240
    max_position: int = 2048
    ln_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_token_id: int = 2


def opt_2_7b() -> OPTConfig:
    return OPTConfig()


def opt_6_7b() -> OPTConfig:
    return OPTConfig(d_model=4096, d_ff=16384)


def tiny_config(**kw) -> OPTConfig:
    defaults = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4,
                    d_ff=64, max_position=64)
    defaults.update(kw)
    return OPTConfig(**defaults)


class OPTAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class OPTDecoderLayer(nn.Module):
    """Pre-LN self-attention and ReLU FFN, both residual (opt.py:113-133)."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.self_attn = OPTAttention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.fc1 = nn.Linear(d, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.ln_eps)

    def qkv(self, x: torch.Tensor, stats=None, collect: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The pre-LN q, k, v of ``x`` (one shared statistic: they read the
        same input)."""
        a, ln = self.self_attn, self.self_attn_layer_norm
        h = layer_norm(x, ln.weight, ln.bias, self.cfg.ln_eps)
        collect_stats(stats, ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
                      h, collect)
        return linear(h, a.q_proj), linear(h, a.k_proj), linear(h, a.v_proj)

    def rest(self, x: torch.Tensor, o: torch.Tensor, stats=None,
             collect: Optional[str] = None) -> torch.Tensor:
        """The attention output's projection and residual, then the FFN."""
        x = x + dense(self.self_attn.out_proj, o, name="self_attn.out_proj", stats=stats,
                      collect=collect)
        ln = self.final_layer_norm
        h = layer_norm(x, ln.weight, ln.bias, self.cfg.ln_eps)
        h = torch.relu(dense(self.fc1, h, name="fc1", stats=stats, collect=collect))
        return x + dense(self.fc2, h, name="fc2", stats=stats, collect=collect)

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None,
                collect: Optional[str] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``cache`` is the additive attention bias."""
        stats: Dict[str, torch.Tensor] = {}
        q, k, v = self.qkv(x, stats, collect)
        o = attention(q, k, v, self.cfg.num_heads, bias=cache)
        return self.rest(x, o, stats, collect), stats


class OPTDecoder(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        # HF OPTLearnedPositionalEmbedding: positions offset by 2
        self.embed_positions = nn.Embedding(cfg.max_position + 2, cfg.d_model)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)


class _OPTModel(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.decoder = OPTDecoder(cfg)


def positions_of(mask: torch.Tensor) -> torch.Tensor:
    """HF's position ids from a 0/1 mask: cumsum(mask) * mask - 1."""
    return torch.cumsum(mask, dim=1) * mask - 1


def causal_mask_bias(mask: Optional[torch.Tensor], s: int, device) -> torch.Tensor:
    """(1 or B, 1, S, S) float32 bias: -1e9 above the diagonal, plus
    ``mask_bias`` of the padding mask (opt.py:146-148)."""
    tril = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    causal = torch.where(tril, 0.0, -1e9).to(torch.float32)[None, None]
    return causal if mask is None else causal + mask_bias(mask)


class OPTForCausalLM(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _OPTModel(cfg)

    @property
    def decoder(self) -> OPTDecoder:
        return self.model.decoder

    def position_embeds(self, positions: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.decoder.embed_positions(positions + 2).to(dtype)

    def embed(self, ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """Token plus position embeddings (opt.py:135-144)."""
        x = embedding(ids, self.decoder.embed_tokens)
        positions = (torch.arange(ids.shape[1], device=ids.device)[None]
                     if attn_mask is None else positions_of(attn_mask))
        return x + self.position_embeds(positions, x.dtype)

    def logits_from_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm and the tied head: float32 logits."""
        ln = self.decoder.final_layer_norm
        x = layer_norm(x, ln.weight, ln.bias, self.cfg.ln_eps)
        return linear_f32(x, self.decoder.embed_tokens)

    def forward_embeds(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.decoder.layers:
            x, _ = layer(x, bias)
        return self.logits_from_hidden(x)

    def forward(self, input_ids: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) ids -> (B, S, V) float32 logits (opt.py:151-162)."""
        x = self.embed(input_ids, attn_mask)
        return self.forward_embeds(x, causal_mask_bias(attn_mask, x.shape[1], x.device))

    def per_sample_loss(self, input_ids: torch.Tensor,
                        attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B,) next-token CE, mean over the valid targets, in the
        logsumexp form (opt.py:165-176)."""
        logits = self(input_ids, attn_mask)[:, :-1]
        targets = input_ids[:, 1:]
        valid = (torch.ones_like(targets, dtype=torch.bool) if attn_mask is None
                 else attn_mask[:, 1:] > 0)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, targets[..., None])[..., 0]
        ce = torch.where(valid, lse - picked, torch.zeros_like(lse))
        return ce.sum(-1) / valid.sum(-1).clamp(min=1)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Seeded random init with the JAX ``init_params`` stds."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                normal_(mod.weight, 0.02, gen)
                if isinstance(mod, nn.Linear):
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def build_model(cfg: OPTConfig, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> OPTForCausalLM:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype``, frozen; ``seed`` draws a random init from its own
    ``torch.Generator``, ``seed=None`` leaves the storage for a loader."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = OPTForCausalLM(cfg).to(dtype)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


def _block_forward(block, x, cache, collect=None):
    return block(x, cache, collect=collect)


def make_stack(cfg: OPTConfig, name: str, blocks, prepare) -> StackSpec:
    """The decoder layers as a pruning stack, per-row masks."""
    return StackSpec(name, cfg.num_layers, LINEAR_NAMES, True, prepare, _block_forward,
                     blocks)


def make_adapter(model: OPTForCausalLM) -> ModelAdapter:
    """``model.decoder.layers`` on the LM loss (opt.py:179-201)."""
    def prepare(m, batch):
        ids, mask = batch["input_ids"], batch.get("attn_mask")
        x = m.embed(ids, mask)
        return x, causal_mask_bias(mask, ids.shape[1], ids.device)

    stack = make_stack(model.cfg, "model.decoder.layers", lambda m: m.decoder.layers,
                       prepare)
    return ModelAdapter(
        name="opt", model=model,
        loss_fn=lambda m, b: m.per_sample_loss(b["input_ids"], b.get("attn_mask")),
        stacks=[stack], model_prefixes={stack.name: "model"})


# -- generation (opt.py:210-346) ---------------------------------------------------

@dataclass
class OPTCache:
    """Rows = B * beams, sample-major, in the activation dtype:

    * ``k``/``v``: (L, rows, P + S, D), the prefix's keys and values (P
      slots), then one slot per generated step;
    * ``key_mask``: (rows, P + S), the prefix's mask padded with zeros (the
      generated slots are valid up to the step, positionally)."""

    k: torch.Tensor
    v: torch.Tensor
    key_mask: torch.Tensor

    def reorder(self, rows: torch.Tensor, length: int) -> "OPTCache":
        """Beam search's gather of every layer's K/V by beam."""
        self.k = self.k.index_select(1, rows)
        self.v = self.v.index_select(1, rows)
        return self


def init_gen_cache(model: OPTForCausalLM, prefix_embeds: torch.Tensor,
                   prefix_mask: torch.Tensor, max_new_tokens: int) -> OPTCache:
    """Prefill: one forward over the position-embedded prefix (without the
    prompt's last token), keeping every layer's K/V."""
    bias = causal_mask_bias(prefix_mask, prefix_embeds.shape[1], prefix_embeds.device)
    x, ks, vs = prefix_embeds, [], []
    pad = (0, 0, 0, max_new_tokens)
    for layer in model.decoder.layers:
        q, k, v = layer.qkv(x)
        ks.append(F.pad(k, pad))
        vs.append(F.pad(v, pad))
        x = layer.rest(x, attention(q, k, v, model.cfg.num_heads, bias=bias))
    key_mask = F.pad(prefix_mask.to(torch.long), (0, max_new_tokens))
    return OPTCache(torch.stack(ks), torch.stack(vs), key_mask)


def make_opt_step_fn(model: OPTForCausalLM, prefix_len: int, pos0: int,
                     max_new_tokens: int):
    """One-token decode step: the token of step ``pos`` has position id
    ``pos0 + pos`` and cache slot ``prefix_len + pos`` (BLIP-2 OPT's text
    positions restart after the query embeds, so the two part)."""
    cfg, dec = model.cfg, model.decoder
    slots = torch.arange(prefix_len + max_new_tokens, device=dec.embed_tokens.weight.device)

    def step_fn(tok: torch.Tensor, pos: int, cache: OPTCache):
        x = embedding(tok, dec.embed_tokens)[:, None, :]
        x = x + dec.embed_positions.weight[pos0 + pos + 2][None, None].to(x.dtype)
        write = prefix_len + pos
        valid = (cache.key_mask > 0) | ((slots >= prefix_len) & (slots <= write))[None]
        bias = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, None, :]
        for i, layer in enumerate(dec.layers):
            q, k, v = layer.qkv(x)
            cache.k[i, :, write] = k[:, 0]
            cache.v[i, :, write] = v[:, 0]
            x = layer.rest(x, attention(q, cache.k[i], cache.v[i], cfg.num_heads, bias=bias))
        return model.logits_from_hidden(x[:, 0]), cache

    return step_fn


@torch.inference_mode()
def generate_from_embeds(model: OPTForCausalLM, prefix_embeds: torch.Tensor,
                         prefix_mask: torch.Tensor, last_tok: torch.Tensor,
                         gen: GenerateConfig, use_beam: bool = True,
                         pos0: Optional[int] = None, len_offset: int = 0,
                         prompt_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, max_new_tokens) tokens from a position-embedded prefix that
    excludes the prompt's last token (``last_tok``, fed first). ``pos0`` is
    ``last_tok``'s position id (default: its slot); ``len_offset`` = prompt
    length - 1. With beams every row is repeated before the prefill, as the
    JAX package does."""
    b, p = prefix_embeds.shape[:2]
    pos0 = p if pos0 is None else pos0
    nb = gen.num_beams if use_beam and gen.num_beams > 1 else 1
    if nb > 1:
        prefix_embeds, prefix_mask, last_tok, prompt_tokens = (
            expand_for_beams(t, nb) for t in (prefix_embeds, prefix_mask, last_tok,
                                             prompt_tokens))
    cache = init_gen_cache(model, prefix_embeds, prefix_mask, gen.max_new_tokens)
    step = make_opt_step_fn(model, p, pos0, gen.max_new_tokens)
    run = beam_generate if nb > 1 else greedy_generate
    return run(step, cache, b, gen, tok0=last_tok, len_offset=len_offset,
               prompt_tokens=prompt_tokens, device=prefix_embeds.device)
