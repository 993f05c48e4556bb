"""Plain EVA-CLIP (LAVIS ``eva_clip``, EVA-CLIP-g.json): the EVA ViT visual
tower with its final LayerNorm and head on the cls token, the text
transformer (causal, pooled at the end-of-text id, the largest id), and
zero-shot classification as LAVIS's eva_model.py:512-544 computes it:
every template of a class encoded and normalised, their mean normalised
again, logits 100 times the cosine of the normalised image features.

Weights by the program's parameter names, from a plain dict. Imports
nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.blip2_t5 import vit
from portbench.reference.numerics import Prec, attention, layer_norm


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def image_features(P: Dict, cfg: Dict, p: Prec, images: torch.Tensor) -> torch.Tensor:
    v = cfg["visual"]
    x = vit(P, v, p, images, root="visual")[:, 0]
    x = layer_norm(x, P["visual.norm.weight"], P["visual.norm.bias"], v["ln_eps"])
    return p.linear(x, P["visual.head.weight"], P["visual.head.bias"])


def text_features(P: Dict, cfg: Dict, p: Prec, ids: torch.Tensor) -> torch.Tensor:
    t = cfg["text"]
    x = P["token_embedding.weight"][ids].to(torch.float32)
    x = x + P["positional_embedding"][: ids.shape[1]].to(torch.float32)
    n = ids.shape[1]
    causal = torch.where(torch.ones(n, n, dtype=torch.bool, device=x.device).tril(),
                         0.0, float("-inf")).to(torch.float32)[None, None]
    heads, eps = t["heads"], t["ln_eps"]
    for i in range(t["layers"]):
        pre = f"transformer.resblocks.{i}."
        h = layer_norm(x, P[pre + "ln_1.weight"], P[pre + "ln_1.bias"], eps)
        q, k, v = p.linear(h, P[pre + "attn.in_proj.weight"],
                           P[pre + "attn.in_proj.bias"]).chunk(3, dim=-1)
        o = attention(p, q, k, v, heads, (t["width"] // heads) ** -0.5, causal)
        x = x + p.linear(o, P[pre + "attn.out_proj.weight"], P[pre + "attn.out_proj.bias"])
        h = layer_norm(x, P[pre + "ln_2.weight"], P[pre + "ln_2.bias"], eps)
        h = p.linear(h, P[pre + "mlp.c_fc.weight"], P[pre + "mlp.c_fc.bias"])
        h = F.gelu(h, approximate="tanh")
        x = x + p.linear(h, P[pre + "mlp.c_proj.weight"], P[pre + "mlp.c_proj.bias"])
    x = layer_norm(x, P["ln_final.weight"], P["ln_final.bias"], eps)
    x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    return p.matmul(x, P["text_projection"])


def class_embeddings(P: Dict, cfg: Dict, p: Prec, prompt_ids: torch.Tensor,
                     chunk: int = 1024) -> torch.Tensor:
    """(C, T, ctx) prompts -> (C, embed) normalised class embeddings."""
    c, t, ctx = prompt_ids.shape
    flat = prompt_ids.reshape(c * t, ctx)
    feats = torch.cat([normalize(text_features(P, cfg, p, flat[i:i + chunk]))
                       for i in range(0, flat.shape[0], chunk)])
    return normalize(feats.reshape(c, t, -1).mean(dim=1))


def logits(P: Dict, cfg: Dict, p: Prec, images: torch.Tensor,
           classes: torch.Tensor) -> torch.Tensor:
    """(B, C) zero-shot logits against (C, embed) class embeddings."""
    return 100.0 * normalize(image_features(P, cfg, p, images)) @ classes.T
