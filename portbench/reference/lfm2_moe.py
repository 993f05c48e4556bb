"""Plain LFM2-MoE (LiquidAI LFM2-8B-A1B, HF ``Lfm2MoeForCausalLM``) in float32:
the forward, the per-sample next-token loss, and one block at a time with
Wanda's statistics, as ``fine.prune_stack``'s ``block_fn`` takes it.

Weights are a dict under the HF names (``model.layers.{i}.conv.in_proj.weight``,
``...feed_forward.experts.{e}.w1.weight``, ``...feed_forward.expert_bias``,
``model.embedding_norm.weight``; the output head is
``model.embed_tokens.weight``, tied). Every product goes through ``Prec``
(float32, or fp8 operands in the control), in the forward and, under
autograd, in the backward too (``_Linear``, ``_Matmul``; ``_Linear`` keeps
the stored weight, not a float32 copy, so a whole-model backward holds
activations only).

* The short convolution is the explicit sum of its taps:
  y[t] = sum_j w[j] (B x)[t - (L - 1) + j], zero before the window.
* Attention: RMSNorm of each head's q and k, then RoPE (rotate_half, theta
  from the config), causal softmax over the full score matrix, KV heads
  repeated for their query groups.
* The sparse layer: the router's sigmoid, the top k of sigmoid + expert_bias
  chosen here, their sigmoids normalised to sum 1 (+1e-6, as HF); then a
  loop over experts, each on the tokens that chose it. Where a check
  follows another run's routing, that run's choice is given and the
  reference's own is handed back beside it.

Departures from the published model: none in the equations; the weights
are random and the tokens synthetic (the configuration's ``assumed``).

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.numerics import Prec, rms_norm

STACK = "model.layers"
ATTN = "full_attention"
MLP = ("w1", "w3", "w2")


def weight_key(i: int, local: str) -> str:
    return f"{STACK}.{i}.{local}.weight"


def sparse(cfg: Dict, i: int) -> bool:
    return i >= cfg["num_dense_layers"]


def block_linears(cfg: Dict, i: int) -> List[str]:
    """Block i's pruned linears: the operator's projections, then the dense
    SwiGLU's or each expert's."""
    if cfg["layer_types"][i] == ATTN:
        op = ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj"]
    else:
        op = ["conv.in_proj", "conv.out_proj"]
    if not sparse(cfg, i):
        return op + [f"feed_forward.{n}" for n in MLP]
    return op + [f"feed_forward.experts.{e}.{n}" for e in range(cfg["num_experts"])
                 for n in MLP]


class _Linear(torch.autograd.Function):
    """x W^T through ``prec``; the backward's two products through it too."""

    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.prec = prec
        ctx.save_for_backward(x, w)
        return prec.linear(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.prec
        gx = p.matmul(g, w) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = p.matmul(g.reshape(-1, g.shape[-1]).T, x.reshape(-1, x.shape[-1]))
        return gx, gw, None


class _Matmul(torch.autograd.Function):
    """a @ b through ``prec``, the backward's two products through it too
    (autograd would otherwise carry the gradient through fp8 unscaled)."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.prec = prec
        ctx.save_for_backward(a, b)
        return prec.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.prec
        ga = p.matmul(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = p.matmul(a.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


def lin(p: Prec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Linear.apply(x, w, p)


def rope(cfg: Dict, seq: int, device):
    """float32 (S, Dh) cos and sin, rotate_half layout."""
    dh = cfg["hidden_size"] // cfg["num_attention_heads"]
    theta = cfg["rope_theta"] if "rope_theta" in cfg else cfg["rope_parameters"]["rope_theta"]
    inv = 1.0 / (float(theta) ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                               device=device) / dh))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _fold(stats, name, x):
    """Wanda's statistic of one linear's input: the sum of x^2 per column."""
    if stats is None:
        return
    c = x.reshape(-1, x.shape[-1]).to(torch.float32).square().sum(dim=0)
    stats[name] = stats[name] + c if name in stats else c


def short_conv(W, cfg, p, pre, h, stats):
    taps = cfg["conv_L_cache"]
    _fold(stats, "conv.in_proj", h)
    d = cfg["hidden_size"]
    bcx = lin(p, h, W[pre + "conv.in_proj.weight"])
    b, c, x = bcx[..., :d], bcx[..., d:2 * d], bcx[..., 2 * d:]
    bx = b * x
    k = W[pre + "conv.conv.weight"].to(torch.float32).reshape(d, taps)  # (d, 1, L)
    s = bx.shape[1]
    padded = F.pad(bx, (0, 0, taps - 1, 0))  # zeros before the window
    y = sum(k[:, j] * padded[:, j:j + s] for j in range(taps))
    y = c * y
    _fold(stats, "conv.out_proj", y)
    return lin(p, y, W[pre + "conv.out_proj.weight"])


def attention(W, cfg, p, pre, h, stats, cos, sin):
    b, s, _ = h.shape
    hq, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, eps = cfg["hidden_size"] // hq, cfg["norm_eps"]
    for n in ("q_proj", "k_proj", "v_proj"):
        _fold(stats, f"self_attn.{n}", h)
    q = lin(p, h, W[pre + "self_attn.q_proj.weight"]).reshape(b, s, hq, dh)
    k = lin(p, h, W[pre + "self_attn.k_proj.weight"]).reshape(b, s, hk, dh)
    v = lin(p, h, W[pre + "self_attn.v_proj.weight"]).reshape(b, s, hk, dh)
    q = rms_norm(q, W[pre + "self_attn.q_layernorm.weight"], eps).transpose(1, 2)
    k = rms_norm(k, W[pre + "self_attn.k_layernorm.weight"], eps).transpose(1, 2)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    k = k.repeat_interleave(hq // hk, dim=1)
    v = v.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
    scores = _Matmul.apply(q, k.transpose(-1, -2), p) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = _Matmul.apply(torch.softmax(scores, dim=-1), v, p).transpose(1, 2).reshape(b, s, hq * dh)
    _fold(stats, "self_attn.out_proj", o)
    return lin(p, o, W[pre + "self_attn.out_proj.weight"])


def swiglu(W, p, pre, h, stats, name):
    _fold(stats, name + "w1", h)
    _fold(stats, name + "w3", h)
    a = lin(p, h, W[pre + name + "w1.weight"])
    g = lin(p, h, W[pre + name + "w3.weight"])
    hh = F.silu(a) * g
    _fold(stats, name + "w2", hh)
    return lin(p, hh, W[pre + name + "w2.weight"])


def route(W, cfg, p, pre, flat, given=None):
    """(T, k) experts chosen by sigmoid + expert_bias, or ``given``'s choice
    where the reference follows another run's routing; their weights, the
    chosen sigmoids normalised to sum 1, unscaled (the published configs'
    ``use_expert_bias``, ``norm_topk_prob`` and ``routed_scaling_factor``
    1); and the reference's own choice."""
    probs = torch.sigmoid(lin(p, flat, W[pre + "feed_forward.gate.weight"]))
    choice = probs + W[pre + "feed_forward.expert_bias"].to(torch.float32)
    own = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
    sel = own if given is None else given.to(own.device, torch.long)
    wts = probs.gather(1, sel)
    return sel, wts / (wts.sum(dim=-1, keepdim=True) + 1e-6), own


def moe(W, cfg, p, pre, h, stats, given=None, seen=None):
    """The sparse layer; ``given`` (T, k) the experts to use in place of
    the reference's own choice, ``seen`` a list that takes its own choice."""
    flat = h.reshape(-1, h.shape[-1])
    sel, wts, own = route(W, cfg, p, pre, flat, given)
    if seen is not None:
        seen.append(own)
    out = torch.zeros_like(flat)
    for e in range(cfg["num_experts"]):
        name = f"feed_forward.experts.{e}."
        hit = sel == e  # (T, k): at most one True a row
        tok = hit.any(dim=-1).nonzero()[:, 0]
        if stats is not None:
            for n in MLP:
                cols = cfg["moe_intermediate_size"] if n == "w2" else cfg["hidden_size"]
                stats.setdefault(name + n, torch.zeros(cols, device=h.device))
        if tok.numel() == 0:
            continue
        y = swiglu(W, p, pre, flat[tok], stats, name)
        out = out.index_add(0, tok, y * (wts * hit).sum(dim=-1)[tok, None])
    return out.reshape(h.shape)


def block(W: Dict[str, torch.Tensor], cfg: Dict, p: Prec, i: int, x: torch.Tensor,
          cache, stats: Optional[Dict[str, torch.Tensor]] = None,
          mode: Optional[str] = None, given=None, seen=None) -> torch.Tensor:
    """Layer i on float32 x (B, S, d); ``cache`` the (cos, sin) tables; with
    ``stats`` (mode "wanda") each pruned linear's input statistic is folded
    into it, an expert's over the tokens routed to it only. ``given`` and
    ``seen`` are the sparse layer's (``moe``)."""
    if mode not in (None, "wanda"):
        raise ValueError(f"the reference folds Wanda's statistics only, not {mode!r}")
    pre, eps = f"{STACK}.{i}.", cfg["norm_eps"]
    cos, sin = cache
    h = rms_norm(x, W[pre + "operator_norm.weight"], eps)
    if cfg["layer_types"][i] == ATTN:
        x = x + attention(W, cfg, p, pre, h, stats, cos, sin)
    else:
        x = x + short_conv(W, cfg, p, pre, h, stats)
    h = rms_norm(x, W[pre + "ffn_norm.weight"], eps)
    if sparse(cfg, i):
        return x + moe(W, cfg, p, pre, h, stats, given, seen)
    return x + swiglu(W, p, pre, h, stats, "feed_forward.")


def embed(W: Dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    return W["model.embed_tokens.weight"][ids].to(torch.float32)


def per_sample_loss(W: Dict[str, torch.Tensor], cfg: Dict, p: Prec, ids: torch.Tensor,
                    routes: Optional[Dict] = None, seen: Optional[Dict] = None
                    ) -> torch.Tensor:
    """(B,) mean next-token cross-entropy of each window."""
    logits = forward(W, cfg, p, ids, routes, seen)[:, :-1]
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, ids[:, 1:, None])[..., 0]
    return nll.mean(dim=-1)


def forward(W: Dict[str, torch.Tensor], cfg: Dict, p: Prec, ids: torch.Tensor,
            routes: Optional[Dict] = None, seen: Optional[Dict] = None) -> torch.Tensor:
    """(B, S, V) float32 logits. ``routes`` {layer: (B S, k) experts} a
    sparse layer uses in place of its own choice; ``seen`` {layer: list}
    takes each sparse layer's own choice."""
    x = embed(W, ids)
    cache = rope(cfg, ids.shape[1], ids.device)
    for i in range(cfg["num_hidden_layers"]):
        x = block(W, cfg, p, i, x, cache,
                  given=None if routes is None else routes.get(i),
                  seen=None if seen is None else seen.setdefault(i, []))
    x = rms_norm(x, W["model.embedding_norm.weight"], cfg["norm_eps"])
    return lin(p, x, W["model.embed_tokens.weight"])
