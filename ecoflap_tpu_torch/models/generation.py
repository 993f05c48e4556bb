"""Autoregressive generation: greedy and beam search over a KV cache (port
of ``ecoflap_tpu/models/generation.py``; the reference calls HF
``generate``, blip2_t5.py:416-431: num_beams 5, min_length 1, length
penalty -1 for VQA and 1.0 for captions).

The JAX loop is a ``lax.scan`` over ``max_new_tokens`` steps; here it is a
Python loop whose state stays on the device: every test on a device value
(finished beams, ``improving``, the min-length mask's -inf, the repetition
penalty's seen set) is a tensor operation, so nothing waits for the card
until the final tokens go to the host. Beam search copies HF's vectorized
``_beam_search`` (``early_stopping=False``) step for step, as the JAX
package does:

* two beam sets per sample: ``num_beams`` running beams and ``num_beams``
  finished hypotheses, scored by ``sum_logprobs / len ** length_penalty``;
* each step takes the top ``2 * num_beams`` candidates over
  ``num_beams * vocab``; those that hit EOS (or the last step) join the
  finished set if they rank below ``num_beams``, the best ``num_beams``
  others run on;
* processors (repetition penalty, the min-length EOS mask) act on the
  log-softmax in beam mode and on the raw logits in greedy mode;
* a sample stops taking hypotheses once its best running beam, normalised
  at the current length, cannot beat its worst finished one.

Every top-k goes through ``stable_topk``: equal values keep the lower index
first, as ``jax.lax.top_k`` does, and beam search makes such ties on
purpose (an unfinished slot carries -1e9, and -1e9 + logp rounds to the same
float32 for every |logp| < 32).

The model plugs in as ``step_fn(tokens, pos, cache) -> (logits, cache)``;
beam search reorders the cache through ``cache.reorder(rows, length)``.
T5's and BERT's (BLIP-1 captions) steps and caches live here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ecoflap_tpu_torch.models import t5 as t5_mod
from ecoflap_tpu_torch.models.bert import make_cache as bert_cache_biases
from ecoflap_tpu_torch.models.layers import (
    attention,
    embedding,
    layer_norm,
    linear,
    linear_f32,
    mask_bias,
    rms_norm,
)

StepFn = Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]

NEG = -1.0e9


@dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 30
    num_beams: int = 5
    min_length: int = 1
    length_penalty: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_id: int = 1
    pad_token_id: int = 0
    bos_token_id: int = 0  # decoder_start for T5


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, largest first, equal values in
    index order (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# -- greedy ----------------------------------------------------------------------

def greedy_generate(step_fn: StepFn, cache: Any, batch_size: int, gen: GenerateConfig,
                    tok0: Optional[torch.Tensor] = None, len_offset: int = 0,
                    prompt_tokens: Optional[torch.Tensor] = None, *,
                    device: torch.device) -> torch.Tensor:
    """(B, max_new_tokens) greedy tokens, pad after EOS (HF ``_sample``:
    processors on the raw logits, finished rows feed pad).

    ``tok0`` and ``len_offset`` serve decoder-only prefix models: ``tok0``
    is each row's last prompt token (not yet in the cache) and
    ``len_offset`` = prompt length - 1, so HF's ``cur_len`` counts the
    prompt; only ``min_length`` reads it. T5 passes neither."""
    S = gen.max_new_tokens
    tok = (torch.full((batch_size,), gen.bos_token_id, dtype=torch.long, device=device)
           if tok0 is None else tok0)
    seqs = torch.full((batch_size, S), gen.pad_token_id, dtype=torch.long, device=device)
    done = torch.zeros(batch_size, dtype=torch.bool, device=device)
    pad = torch.full_like(tok, gen.pad_token_id)
    for pos in range(S):
        logits, cache = step_fn(tok, pos, cache)
        if gen.repetition_penalty != 1.0:
            logits = _apply_repetition_penalty(
                logits, seqs, pos, gen, _prompt_seen(prompt_tokens, logits.shape[-1]))
        logits = _mask_min_length(logits, pos + len_offset, gen)
        nxt = torch.where(done, pad, torch.argmax(logits, dim=-1))
        seqs[:, pos] = nxt
        done = done | (nxt == gen.eos_token_id)
        tok = nxt
    return seqs


def _mask_min_length(logits: torch.Tensor, pos: int, gen: GenerateConfig) -> torch.Tensor:
    """``pos`` is the 0-based index of the token being generated, a host
    int; HF masks EOS while cur_len (decoder_start included) < min_length."""
    if pos + 1 >= gen.min_length:
        return logits
    logits = logits.clone()
    logits[:, gen.eos_token_id] = -float("inf")
    return logits


# -- beam search -----------------------------------------------------------------

def beam_generate(step_fn: StepFn, cache: Any, batch_size: int, gen: GenerateConfig,
                  tok0: Optional[torch.Tensor] = None, len_offset: int = 0,
                  prompt_tokens: Optional[torch.Tensor] = None, *,
                  device: torch.device) -> torch.Tensor:
    """HF's vectorized ``_beam_search`` (``early_stopping=False``,
    ``do_sample=False``), token for token. ``cache`` holds B * num_beams
    rows, sample-major. Returns each sample's best finished hypothesis,
    (B, max_new_tokens), EOS included, pad after.

    ``tok0``/``len_offset``: see ``greedy_generate``. ``len_offset`` feeds
    only the min-length mask: HF normalises a hypothesis by its generated
    length alone."""
    nb = gen.num_beams
    K = 2 * nb  # HF's beams to keep: (number of eos ids + 1) * num_beams
    S = gen.max_new_tokens
    flat = batch_size * nb
    i64 = dict(dtype=torch.long, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    tok = torch.full((flat,), gen.bos_token_id, **i64) if tok0 is None else tok0
    # only beam 0 is live at step 0, so the frontier spreads out
    run_scores = torch.full((batch_size, nb), NEG, **f32)
    run_scores[:, 0] = 0.0
    run_seqs = torch.full((batch_size, nb, S), gen.pad_token_id, **i64)
    fin_seqs = torch.full((batch_size, nb, S), gen.pad_token_id, **i64)
    fin_scores = torch.full((batch_size, nb), NEG, **f32)
    is_finished = torch.zeros((batch_size, nb), dtype=torch.bool, device=device)
    # per sample: can the running beams still beat the finished set?
    improving = torch.ones((batch_size, 1), dtype=torch.bool, device=device)
    # only the top nb of the K candidates may finish
    top_nb = (torch.arange(K, device=device) < nb)[None, :]
    bidx = torch.arange(batch_size, device=device)[:, None]
    for pos in range(S):
        logits, cache = step_fn(tok, pos, cache)
        # HF _beam_search: log_softmax first, then the processors
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        vocab = logp.shape[-1]
        if gen.repetition_penalty != 1.0:
            logp = _apply_repetition_penalty(logp, run_seqs.reshape(flat, S), pos, gen,
                                             _prompt_seen(prompt_tokens, vocab))
        logp = _mask_min_length(logp, pos + len_offset, gen)

        cand = (run_scores.reshape(flat, 1) + logp).reshape(batch_size, nb * vocab)
        topk_logp, topk_idx = stable_topk(cand, K)  # (B, K), beam-major flat index
        src_beam = topk_idx // vocab
        topk_tok = topk_idx % vocab
        topk_seqs = run_seqs[bidx, src_beam]  # (B, K, S)
        topk_seqs[:, :, pos] = topk_tok

        # stopping criteria: EOS, or the last step
        hits = (topk_tok == gen.eos_token_id) | (pos + 1 >= S)

        # the next running beams: the best nb candidates that did not stop
        run_cand = topk_logp + hits.to(torch.float32) * NEG
        _, next_idx = stable_topk(run_cand, nb)
        run_seqs = topk_seqs[bidx, next_idx]
        run_scores = run_cand.gather(1, next_idx)
        src_run = src_beam.gather(1, next_idx)

        # the finished set: length-normalised (the generated length, HF
        # utils.py:3087), rank < nb only, closed once a sample cannot improve
        norm = float(np.float32(pos + 1) ** np.float32(gen.length_penalty))  # float32 pow
        eligible = hits & top_nb
        fin_cand = topk_logp / norm
        fin_cand = fin_cand + (~eligible).to(torch.float32) * NEG
        fin_cand = fin_cand + (~improving).to(torch.float32) * NEG
        fin_scores, keep = stable_topk(torch.cat([fin_scores, fin_cand], dim=1), nb)
        fin_seqs = torch.cat([fin_seqs, topk_seqs], dim=1)[bidx, keep]
        is_finished = torch.cat([is_finished, eligible], dim=1).gather(1, keep)

        # early_stopping=False: the best running beam at the current length
        # against the worst finished hypothesis
        best_running = run_scores[:, :1] / norm
        worst_fin = torch.where(is_finished, fin_scores.amin(dim=1, keepdim=True), NEG)
        improving = improving & (best_running > worst_fin).any(dim=-1, keepdim=True)

        cache = cache.reorder((bidx * nb + src_run).reshape(-1), pos + 1)
        tok = run_seqs[:, :, pos].reshape(flat)
    return fin_seqs[:, 0]  # sorted: slot 0 is the best hypothesis


def _apply_repetition_penalty(scores: torch.Tensor, seqs: torch.Tensor, pos: int,
                              gen: GenerateConfig,
                              seen0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CTRL penalty over the prompt and the tokens generated before ``pos``
    (HF RepetitionPenaltyLogitsProcessor): score / penalty where positive,
    score * penalty where negative. ``seen0`` (rows, V) marks a decoder-only
    model's prompt; without it (T5) decoder_start is the only prompt token."""
    seen = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    seen.scatter_(1, seqs[:, :pos], True)
    if seen0 is None:
        seen[:, gen.bos_token_id] = True
    else:
        seen = seen | seen0
    p = gen.repetition_penalty
    return torch.where(seen, torch.where(scores < 0, scores * p, scores / p), scores)


def _prompt_seen(prompt_tokens: Optional[torch.Tensor], vocab: int
                 ) -> Optional[torch.Tensor]:
    """(rows, T) prompt ids -> (rows, V) bool seen mask (None passes)."""
    if prompt_tokens is None:
        return None
    seen = torch.zeros((prompt_tokens.shape[0], vocab), dtype=torch.bool,
                       device=prompt_tokens.device)
    return seen.scatter_(1, prompt_tokens, True)


def expand_for_beams(tree: Any, num_beams: int) -> Any:
    """Repeat every tensor's batch row ``num_beams`` times, sample-major
    (``jnp.repeat`` along axis 0), through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.repeat_interleave(num_beams, dim=0)
    if isinstance(tree, dict):
        return {k: expand_for_beams(v, num_beams) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(expand_for_beams(v, num_beams) for v in tree)
    return tree


# -- T5 cached decoding ------------------------------------------------------------

@dataclass
class T5Cache:
    """The decoder's cache. Keys and values are stored in float32 holding
    values already rounded to the activation dtype: the JAX cache's values
    in that dtype, widened once, so the step's float32 attention products
    need no cast.

    * ``self_kv``: (L, 2, rows, H, S, Dh), rows = B * beams, sample-major;
    * ``cross_kv``: (L, 2, B, H, Senc, Dh), one per sample: every beam of a
      sample attends to the same encoder output, so the beams' queries are
      stacked against one copy (the JAX cache repeats it per beam and
      gathers it with the self K/V every step: identical values);
    * ``cross_bias``: (B, 1, 1, Senc), ``mask_bias`` of the encoder mask.
    """

    self_kv: torch.Tensor
    cross_kv: torch.Tensor
    cross_bias: torch.Tensor

    def reorder(self, rows: torch.Tensor, length: int) -> "T5Cache":
        """Beam search's gather of the self K/V (positions < ``length``;
        later ones are still zero in every row)."""
        head = self.self_kv[:, :, :, :, :length]
        self.self_kv[:, :, :, :, :length] = head.index_select(2, rows)
        return self


def t5_init_cache(model: t5_mod.T5Model, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                  max_new_tokens: int, num_beams: int = 1) -> T5Cache:
    """Every layer's cross K/V (one product per layer per sequence: the
    loop never touches the encoder again) and zeroed self K/V."""
    cfg = model.cfg
    b, senc, _ = enc_out.shape
    h, dh = cfg.num_heads, cfg.d_kv
    cross = []
    for blk in model.decoder.block:
        att = blk.layer[1].EncDecAttention
        cross.append(torch.stack([
            linear(enc_out, lin).reshape(b, senc, h, dh).transpose(1, 2)
            for lin in (att.k, att.v)]))
    self_kv = torch.zeros((cfg.num_decoder_layers, 2, b * num_beams, h, max_new_tokens, dh),
                          dtype=torch.float32, device=enc_out.device)
    return T5Cache(self_kv, torch.stack(cross).to(torch.float32), mask_bias(enc_mask))


def make_t5_step_fn(model: t5_mod.T5Model, max_new_tokens: int,
                    num_beams: int = 1) -> StepFn:
    """One-token decoder step over the cache (generation.py:272-378). The
    self-attention's relative-position bias rows are made once for every
    (pos, key) pair."""
    cfg = model.cfg
    eps, nb = cfg.ln_eps, num_beams
    dec = model.decoder
    # (H, S, S) causal rel-pos bias; at step pos, keys 0..pos take row pos.
    # The JAX step sets keys > pos to -1e9 (replacing the bias) and attends
    # over all S: their probabilities are exactly 0, so the step attends to
    # keys 0..pos alone
    full_bias = t5_mod.position_bias(cfg, dec.rel_bias, max_new_tokens,
                                     max_new_tokens, False)[0]

    def step_fn(tok: torch.Tensor, pos: int, cache: T5Cache):
        x = embedding(tok, model.shared)[:, None, :]  # (rows, 1, D)
        self_bias = full_bias[None, :, pos:pos + 1, :pos + 1]  # (1, H, 1, pos + 1)
        for layer, blk in enumerate(dec.block):
            sa, ca, ff = blk.layer
            att = sa.SelfAttention
            h = rms_norm(x, sa.layer_norm.weight, eps)
            q = linear(h, att.q)
            kv = cache.self_kv[layer]
            for i, lin in enumerate((att.k, att.v)):
                kv[i, :, :, pos] = linear(h, lin).reshape(kv.shape[1], cfg.num_heads, -1)
            o = _cached_attention(q, kv[0, :, :, :pos + 1], kv[1, :, :, :pos + 1],
                                  self_bias, 1)
            x = x + linear(o, att.o)

            att = ca.EncDecAttention
            h = rms_norm(x, ca.layer_norm.weight, eps)
            ckv = cache.cross_kv[layer]
            o = _cached_attention(linear(h, att.q), ckv[0], ckv[1],
                                  cache.cross_bias, nb)
            x = x + linear(o, att.o)

            mlp = ff.DenseReluDense
            h = rms_norm(x, ff.layer_norm.weight, eps)
            hh = F.gelu(linear(h, mlp.wi_0)) * linear(h, mlp.wi_1)
            x = x + linear(hh, mlp.wo)
        x = rms_norm(x, dec.final_layer_norm.weight, eps)
        return linear_f32(x[:, 0], model.lm_head), cache

    return step_fn


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, rows: int) -> torch.Tensor:
    """q: (G * rows, 1, H * Dh) in the activation dtype; k, v: (G, H, P, Dh)
    float32 holding values of that dtype; ``rows`` consecutive queries share
    one key set. As the JAX step computes it (generation.py:381-392):
    float32 scores, the bias, softmax, the probabilities rounded to the
    activation dtype, P V summed in float32 and rounded once."""
    n, _, inner = q.shape
    g, h, _, dh = k.shape
    qh = q.reshape(g, rows, h, dh).transpose(1, 2).to(torch.float32)  # (G, H, rows, Dh)
    scores = torch.matmul(qh, k.transpose(-1, -2)) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype).to(torch.float32)
    o = torch.matmul(probs, v).to(q.dtype)  # (G, H, rows, Dh)
    return o.transpose(1, 2).reshape(n, 1, inner)


@torch.inference_mode()
def t5_generate(model: t5_mod.T5Model, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                gen: GenerateConfig, use_beam: bool = True) -> torch.Tensor:
    """T5 generation from encoder outputs: (B, max_new_tokens) token ids on
    the device."""
    cfg = model.cfg
    gen = dataclasses.replace(gen, bos_token_id=cfg.decoder_start_token_id,
                              eos_token_id=cfg.eos_token_id,
                              pad_token_id=cfg.pad_token_id)
    nb = gen.num_beams if use_beam and gen.num_beams > 1 else 1
    cache = t5_init_cache(model, enc_out, enc_mask, gen.max_new_tokens, nb)
    step = make_t5_step_fn(model, gen.max_new_tokens, nb)
    run = beam_generate if nb > 1 else greedy_generate
    return run(step, cache, enc_out.shape[0], gen, device=enc_out.device)


# -- BERT cached decoding (BLIP-1 captions) ------------------------------------------

@dataclass
class BertCache:
    """The BERT decoder's cache (bert.py:init_gen_cache), rows = B * beams,
    sample-major, in the weights' dtype:

    * ``self_k``/``self_v``: (L, rows, P + S, D), the prompt prefix's keys
      and values (P tokens), then one slot per generated step;
    * ``cross_k``/``cross_v``: (L, rows, N, D), each layer's encoder keys and
      values, made once;
    * ``cross_bias``: (rows, 1, 1, N); ``key_mask``: (rows, P + S), the
      prompt's mask padded with zeros."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_bias: torch.Tensor
    key_mask: torch.Tensor

    def reorder(self, rows: torch.Tensor, length: int) -> "BertCache":
        """Beam search's gather of every row (the cross K/V and the masks
        are equal over a sample's beams; the self K/V differ)."""
        self.self_k = self.self_k.index_select(1, rows)
        self.self_v = self.self_v.index_select(1, rows)
        return self


def bert_init_cache(dec, prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                    enc: torch.Tensor, max_new_tokens: int) -> BertCache:
    """Prefill over ``prompt_ids`` (the prompt without its last token, which
    the loop feeds first): every layer's self K/V from its input, and its
    cross K/V from the encoder states."""
    bert = dec.bert
    x = bert.embed(prompt_ids)
    cache = bert_cache_biases(dec.cfg, prompt_mask, enc)
    ks, vs, cks, cvs = [], [], [], []
    pad = (0, 0, 0, max_new_tokens)
    for layer in bert.encoder.layer:
        sa, ca = layer.attention.self, layer.crossattention.self
        ks.append(F.pad(F.linear(x, sa.key.weight, sa.key.bias), pad))
        vs.append(F.pad(F.linear(x, sa.value.weight, sa.value.bias), pad))
        kv = enc.to(x.dtype)
        cks.append(F.linear(kv, ca.key.weight, ca.key.bias))
        cvs.append(F.linear(kv, ca.value.weight, ca.value.bias))
        x, _ = layer(x, cache)
    key_mask = F.pad(prompt_mask.to(torch.long), (0, max_new_tokens))
    return BertCache(torch.stack(ks), torch.stack(vs), torch.stack(cks), torch.stack(cvs),
                     cache[1], key_mask)


def make_bert_step_fn(dec, prefix_len: int, max_new_tokens: int) -> StepFn:
    """One-token decode step (bert.py:make_bert_step_fn): the token at step
    ``pos`` sits at position and slot ``prefix_len + pos``; post-LN layers
    with self-attention over the valid slots and cross-attention to the
    image, then the LM head's float32 logits. Attention runs over every slot
    with a -1e9 bias on the empty ones, as the JAX step does."""
    cfg = dec.cfg
    emb = dec.bert.embeddings
    slots = torch.arange(prefix_len + max_new_tokens, device=emb.word_embeddings.weight.device)

    def step_fn(tok: torch.Tensor, pos: int, cache: BertCache):
        write = prefix_len + pos
        w = emb.word_embeddings.weight
        x = w[tok][:, None, :] + emb.position_embeddings.weight[write][None, None].to(w.dtype)
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, cfg.ln_eps)
        valid = (cache.key_mask > 0) | ((slots >= prefix_len) & (slots <= write))[None]
        self_bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        for i, layer in enumerate(dec.bert.encoder.layer):
            att = layer.attention
            sa = att.self
            cache.self_k[i, :, write] = F.linear(x[:, 0], sa.key.weight, sa.key.bias)
            cache.self_v[i, :, write] = F.linear(x[:, 0], sa.value.weight, sa.value.bias)
            o = attention(F.linear(x, sa.query.weight, sa.query.bias), cache.self_k[i],
                          cache.self_v[i], cfg.num_heads, bias=self_bias)
            o = F.linear(o, att.output.dense.weight, att.output.dense.bias)
            ln = att.output.LayerNorm
            x = layer_norm(o + x, ln.weight, ln.bias, cfg.ln_eps)
            ca = layer.crossattention
            o = attention(F.linear(x, ca.self.query.weight, ca.self.query.bias),
                          cache.cross_k[i], cache.cross_v[i], cfg.num_heads,
                          bias=cache.cross_bias)
            o = F.linear(o, ca.output.dense.weight, ca.output.dense.bias)
            ln = ca.output.LayerNorm
            x = layer_norm(o + x, ln.weight, ln.bias, cfg.ln_eps)
            x = layer.ffn(x, None, None)
        return dec.lm_logits(x)[:, 0], cache

    return step_fn


@torch.inference_mode()
def bert_generate(dec, prompt_ids: torch.Tensor, enc: torch.Tensor, gen: GenerateConfig,
                  use_beam: bool = True) -> torch.Tensor:
    """(B, max_new_tokens) tokens from an unpadded prompt shared by the
    batch, with cross-attention to ``enc`` (bert.py:generate_with_encoder):
    the prompt's last token is fed first (``tok0``), and ``len_offset`` =
    prompt length - 1 makes HF's ``cur_len`` count the prompt for the
    min-length mask."""
    b, t = prompt_ids.shape
    nb = gen.num_beams if use_beam and gen.num_beams > 1 else 1
    prefix, last = prompt_ids[:, :-1], prompt_ids[:, -1]
    mask = torch.ones_like(prefix)
    if nb > 1:
        prefix, mask, last, enc = (expand_for_beams(v, nb) for v in (prefix, mask, last, enc))
    cache = bert_init_cache(dec, prefix, mask, enc, gen.max_new_tokens)
    step = make_bert_step_fn(dec, t - 1, gen.max_new_tokens)
    run = beam_generate if nb > 1 else greedy_generate
    return run(step, cache, b, gen, tok0=last, len_offset=t - 1,
               prompt_tokens=expand_for_beams(prompt_ids, nb), device=prompt_ids.device)
