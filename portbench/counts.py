"""The yardstick's arithmetic: the chip's peaks, the operations each job
and each eval batch needs, counted from shapes whatever implements them,
and the perturbation kernel's bytes and operations.

Operations count a multiply-add as two and cover the matrix products and
attention's two products; norms, softmax, activations and the statistics'
squares are left out (a few percent at these widths). Padded text positions
are counted: every implementation computes them.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# The perturbation kernel (csrc/perturb.cu), per element: 10 Philox rounds
# of 2 32x32->64 multiplies (4 operations each) and 4 XORs per counter of
# four elements; per Box-Muller pair 2 shifts, 2 conversions, 2 scalings, a
# clamp, a log, a product, a square root, the angle's product, cos, sin and
# 2 products; per element scale*z and the add. It reads the weight once and
# writes the perturbed copy once.
PERTURB_OPS_PER_ELEMENT = (10 * 8 + 2 * (2 + 13) + 4 * 2) / 4


def perturb_bound_s(numel: int, element_size: int = 2) -> float:
    """Least time of one launch on ``numel`` elements: the larger of its
    bytes over HBM bandwidth and its float32 operations over the float32
    peak (the bytes bound it at every width here)."""
    return max(2 * numel * element_size / HBM_BYTES_PER_S,
               PERTURB_OPS_PER_ELEMENT * numel / F32_FLOPS)


def _lin(tokens: int, d_in: int, d_out: int) -> float:
    return 2.0 * tokens * d_in * d_out


def vit_block_flops(v: Dict) -> float:
    """One EVA ViT block on one image."""
    t, d, f = (v["img_size"] // v["patch_size"]) ** 2 + 1, v["embed_dim"], v["mlp_hidden"]
    return _lin(t, d, 3 * d) + _lin(t, d, d) + 2 * _lin(t, d, f) + 2 * 2.0 * t * t * d


def vit_embed_flops(v: Dict) -> float:
    n, p = (v["img_size"] // v["patch_size"]) ** 2, v["patch_size"]
    return _lin(n, 3 * p * p, v["embed_dim"])


def qformer_flops(q: Dict, image_tokens: int) -> float:
    """The Q-Former's query path on one image."""
    n, d, f, w = q["num_query_tokens"], q["hidden_size"], q["intermediate_size"], q["encoder_width"]
    total = 0.0
    for i in range(q["num_layers"]):
        total += 4 * _lin(n, d, d) + 2 * 2.0 * n * n * d + 2 * _lin(n, d, f)
        if i % q["cross_attention_freq"] == 0:
            total += (2 * _lin(n, d, d) + 2 * _lin(image_tokens, w, d)
                      + 2 * 2.0 * n * image_tokens * d)
    return total


def t5_enc_block_flops(t: Dict, s: int) -> float:
    d, inner, f = t["d_model"], t["num_heads"] * t["d_kv"], t["d_ff"]
    return (3 * _lin(s, d, inner) + _lin(s, inner, d) + 2 * 2.0 * s * s * inner
            + 2 * _lin(s, d, f) + _lin(s, f, d))


def t5_dec_block_flops(t: Dict, s: int, s_enc: int) -> float:
    d, inner, f = t["d_model"], t["num_heads"] * t["d_kv"], t["d_ff"]
    self_attn = 3 * _lin(s, d, inner) + _lin(s, inner, d) + 2 * 2.0 * s * s * inner
    cross = (_lin(s, d, inner) + 2 * _lin(s_enc, d, inner) + _lin(s, inner, d)
             + 2 * 2.0 * s * s_enc * inner)
    return self_attn + cross + 2 * _lin(s, d, f) + _lin(s, f, d)


def blip2_parts(cfg: Dict, traffic: Dict) -> Dict[str, float]:
    """Per-sample operations of each part of BLIP-2 FlanT5 at the mix's
    text lengths."""
    v, q, t = cfg["vit"], cfg["qformer"], cfg["t5"]
    s_enc = q["num_query_tokens"] + traffic["text_input_len"]
    s_dec = traffic["text_output_len"]
    tokens = (v["img_size"] // v["patch_size"]) ** 2 + 1
    return {"vit_embed": vit_embed_flops(v), "vit_block": vit_block_flops(v),
            "qformer": qformer_flops(q, tokens) + _lin(q["num_query_tokens"],
                                                       q["hidden_size"], t["d_model"]),
            "enc_block": t5_enc_block_flops(t, s_enc),
            "dec_block": t5_dec_block_flops(t, s_dec, s_enc),
            "lm_head": _lin(s_dec, t["d_model"], t["vocab_size"])}


def blip2_prune_job_flops(cfg: Dict, traffic: Dict) -> Dict[str, float]:
    """Operations one prune job needs: {"coarse", "fine", "total"}.

    Coarse (MeZO, one draw): each target of block i is scored on every
    coarse microbatch at W + eps z and W - eps z; a perturbation in block i
    leaves everything before it unchanged, so each evaluation needs blocks
    i.. of its stack and the model downstream of the stack; the stacks'
    inputs are computed once and advanced one block at a time. Fine (Wanda
    or SparseGPT): for each pruned stack the inputs of its first block over
    the calibration samples, then each block twice (statistics, then the
    pruned re-forward); SparseGPT adds its Gram sums and its sweep."""
    p = blip2_parts(cfg, traffic)
    nv, ne, nd = cfg["vit"]["depth"], cfg["t5"]["num_layers"], cfg["t5"]["num_decoder_layers"]
    vit_all = p["vit_embed"] + nv * p["vit_block"]
    enc_all, dec_all = ne * p["enc_block"], nd * p["dec_block"]
    tail_vit = p["qformer"] + enc_all + dec_all + p["lm_head"]
    tail_enc = dec_all + p["lm_head"]
    coarse = 0.0
    if traffic.get("score_method", "").startswith("MEZO"):
        b = traffic["num_data_first_stage"]  # samples scored, all microbatches
        # targets a block: the ViT's 4 linears, the encoder's 7, the decoder's 11
        lanes = {s: len(v) // d for (s, v), d in zip(blip2_target_numels(cfg).items(),
                                                      (nv, ne, nd))}
        for i in range(nv):
            coarse += lanes["visual_encoder.blocks"] * 2 * b * (
                (nv - i) * p["vit_block"] + tail_vit)
        for i in range(ne):
            coarse += lanes["t5_model.encoder.block"] * 2 * b * (
                (ne - i) * p["enc_block"] + tail_enc)
        for i in range(nd):
            coarse += lanes["t5_model.decoder.block"] * 2 * b * (
                (nd - i) * p["dec_block"] + p["lm_head"])
        # the stacks' first inputs, then one block forward per block
        coarse += b * (p["vit_embed"] + 2 * (vit_all + p["qformer"]) + enc_all)
        coarse += b * (nv * p["vit_block"] + enc_all + dec_all)
    n = traffic["num_samples"]
    stacks = traffic.get("stacks") or ["visual_encoder.blocks", "t5_model.encoder.block",
                                       "t5_model.decoder.block"]
    fine = 0.0
    if "visual_encoder.blocks" in stacks:
        fine += n * (p["vit_embed"] + 2 * nv * p["vit_block"])
    if "t5_model.encoder.block" in stacks:
        fine += n * (vit_all + p["qformer"] + 2 * enc_all)
    if "t5_model.decoder.block" in stacks:
        fine += n * (vit_all + p["qformer"] + enc_all + 2 * dec_all)
    if traffic["pruning_method"].endswith("sparsegpt_pruner"):
        fine += sparsegpt_flops(cfg, traffic, stacks)
    return {"coarse": coarse, "fine": fine, "total": coarse + fine}


def sparsegpt_flops(cfg: Dict, traffic: Dict, stacks) -> float:
    """SparseGPT's own operations on the ViT stack: the Gram sums X^T X of
    each distinct linear input over the calibration tokens, the Cholesky
    factorisations and inverse (about n^3 each, n the input width), and the
    OBS sweep, whose updates of the columns after each pruned one come to
    about 2 rows n^2 per weight."""
    if "visual_encoder.blocks" not in stacks:
        return 0.0
    v = cfg["vit"]
    tokens = traffic["num_samples"] * ((v["img_size"] // v["patch_size"]) ** 2 + 1)
    d, f = v["embed_dim"], v["mlp_hidden"]
    shapes = [(3 * d, d), (d, d), (f, d), (d, f)]  # qkv, proj, fc1, fc2 (out, in)
    per_block = 0.0
    for rows, n in shapes:
        per_block += 2.0 * tokens * n * n + 3 * n ** 3 + 2.0 * rows * n * n
    return v["depth"] * per_block


def eva_clip_image_flops(cfg: Dict, num_classes: int) -> float:
    """Operations one image needs in zero-shot classification: the visual
    tower, its head and the product with the classifier."""
    v = cfg["visual"]
    return (vit_embed_flops(v) + v["depth"] * vit_block_flops(v)
            + _lin(1, v["embed_dim"], v["head_dim"]) + _lin(1, v["head_dim"], num_classes))


def blip2_target_numels(cfg: Dict) -> Dict[str, int]:
    """Elements of every prunable weight per stack, in the pruner's order."""
    v, t = cfg["vit"], cfg["t5"]
    d, f = v["embed_dim"], v["mlp_hidden"]
    dm, inner, ff = t["d_model"], t["num_heads"] * t["d_kv"], t["d_ff"]
    vit = [3 * d * d, d * d, f * d, d * f]
    enc = [dm * inner] * 3 + [inner * dm] + [dm * ff] * 2 + [ff * dm]
    dec = ([dm * inner] * 3 + [inner * dm]) * 2 + [dm * ff] * 2 + [ff * dm]
    return {"visual_encoder.blocks": vit * v["depth"],
            "t5_model.encoder.block": enc * t["num_layers"],
            "t5_model.decoder.block": dec * t["num_decoder_layers"]}


def blip2_perturb_bound_s(cfg: Dict, traffic: Dict) -> Dict[str, float]:
    """Kernel 2 over one prune job: {"launches", "bound_s"}: two launches
    (W + eps z, W - eps z) per target and coarse microbatch."""
    mb = traffic["num_data_first_stage"] // traffic["batch_size"]
    numels = [n for v in blip2_target_numels(cfg).values() for n in v]
    return {"launches": 2 * mb * len(numels),
            "bound_s": 2 * mb * sum(perturb_bound_s(n) for n in numels)}
