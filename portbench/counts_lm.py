"""The operations a decoder-LM prune job needs (LFM2-MoE), counted from
shapes whatever implements them, as ``counts.py`` counts BLIP-2's.

A multiply-add counts two. Counted: the linears, the router, attention's
two products over the causal half of the score matrix; a sparse layer
counts the ``num_experts_per_tok`` experts each token is routed to, not the
others. Left out: norms, the short convolution's taps, activations, softmax,
the dispatch's gathers and scatters, and the statistics' squares.
"""

from __future__ import annotations

from typing import Dict

ATTN = "full_attention"


def token_flops(cfg: Dict, i: int, seq: int) -> float:
    """Layer i's operations per token in windows of ``seq``."""
    d, hq, hk = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // hq
    if cfg["layer_types"][i] == ATTN:
        # q, k, v, out; then Q K^T and P V over the (seq + 1) / 2 keys a query sees
        op = 2.0 * d * (hq * dh + 2 * hk * dh) + 2.0 * hq * dh * d
        op += 2 * 2.0 * hq * dh * (seq + 1) / 2
    else:
        op = 2.0 * d * 3 * d + 2.0 * d * d
    if i < cfg["num_dense_layers"]:
        ff = 3 * 2.0 * d * cfg["intermediate_size"]
    else:
        ff = (2.0 * d * cfg["num_experts"]
              + cfg["num_experts_per_tok"] * 3 * 2.0 * d * cfg["moe_intermediate_size"])
    return op + ff


def stack_token_flops(cfg: Dict, seq: int) -> float:
    return sum(token_flops(cfg, i, seq) for i in range(cfg["num_hidden_layers"]))


def lm_prune_job_flops(cfg: Dict, mix: Dict) -> Dict[str, float]:
    """{"coarse", "fine", "total"} of one job.

    Coarse (first order, ``GradOnly``): per coarse microbatch the stack
    forward once without grad, the output head forward and its backward to
    the stack's output, then per block a recomputed forward and its backward
    to the weights and the input (twice the forward). Fine (Wanda): every
    block twice over all calibration tokens, statistics pass and pruned
    re-forward."""
    seq = mix["seqlen"]
    stack = stack_token_flops(cfg, seq)
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    b = mix["batch_size"]
    coarse_tokens = max(1, min(mix["num_data_first_stage"], mix["num_samples"]) // b) * b * seq
    coarse = coarse_tokens * (stack * (1 + 1 + 2) + head * 2)
    fine = mix["num_samples"] * seq * 2 * stack
    return {"coarse": coarse, "fine": fine, "total": coarse + fine}


def target_numels(cfg: Dict) -> int:
    """Elements of every pruned weight."""
    d, f, fm = cfg["hidden_size"], cfg["intermediate_size"], cfg["moe_intermediate_size"]
    dh = d // cfg["num_attention_heads"]
    total = 0
    for i in range(cfg["num_hidden_layers"]):
        if cfg["layer_types"][i] == ATTN:
            total += d * dh * (2 * cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"])
        else:
            total += 4 * d * d
        total += 3 * d * f if i < cfg["num_dense_layers"] else cfg["num_experts"] * 3 * d * fm
    return total
