"""BLIP-2's stage-1 Q-Former with its ITC and ITM heads (port of
``ecoflap_tpu/models/blip2_qformer.py``; reference LAVIS blip2_qformer.py,
``compute_sim_matrix`` blip2.py:116-229).

On top of the query-only Q-Former (``models/qformer.py``) the stage-1 model
has text embeddings (word and position, the embeddings' shared LayerNorm),
a text path through the same layers (self-attention, then the text FFN
``intermediate``/``output``, the modules BLIP-2 FlanT5 drops), and heads:
``vision_proj``/``text_proj`` into the ITC space and the 2-way
``itm_head``. Which FFN a token takes: the queries always the query FFN
(``intermediate_query``/``output_query``) after their cross-attention on
the layers that have one, the text tokens always the text FFN; in ITM the
two share each self-attention over ``[queries ; text]``.

Retrieval as the reference scores it: the ITC similarity is the max over
the query tokens of the query-text cosine, then ITM re-ranks each image's
top-k texts and each text's top-k images (``tasks/retrieval.py``'s
``rerank_pair``). The state dict is LAVIS's (``query_tokens``,
``Qformer.bert.*``, ``vision_proj``, ``text_proj``, ``itm_head``); the model
reads frozen ViT features, not images, as the JAX branch does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models import qformer
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.layers import dense, gelu, layer_norm, logits_f32, mask_bias


@dataclass(frozen=True)
class Blip2QformerConfig:
    qformer: qformer.QFormerConfig
    vocab_size: int = 30523
    max_position: int = 512
    embed_dim: int = 256  # the ITC space


def tiny_config() -> Blip2QformerConfig:
    return Blip2QformerConfig(qformer=qformer.tiny_config(), vocab_size=64,
                              max_position=32, embed_dim=16)


class Blip2Qformer(nn.Module):
    def __init__(self, cfg: Blip2QformerConfig):
        super().__init__()
        self.cfg = cfg
        q = cfg.qformer
        d = q.hidden_size
        self.query_tokens = nn.Parameter(torch.empty(1, q.num_query_tokens, d))
        self.Qformer = qformer.QFormer(q)
        emb = self.Qformer.bert.embeddings
        emb.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        emb.position_embeddings = nn.Embedding(cfg.max_position, d)
        for layer in self.Qformer.bert.encoder.layer:  # the text FFN
            layer.intermediate = qformer._Dense(d, q.intermediate_size)
            layer.output = qformer._Output(q.intermediate_size, d, q.ln_eps)
        self.vision_proj = nn.Linear(d, cfg.embed_dim)
        self.text_proj = nn.Linear(d, cfg.embed_dim)
        self.itm_head = nn.Linear(d, 2)

    @property
    def layers(self):
        return self.Qformer.bert.encoder.layer

    def _ln(self, x: torch.Tensor) -> torch.Tensor:
        ln = self.Qformer.bert.embeddings.LayerNorm
        return layer_norm(x, ln.weight, ln.bias, self.cfg.qformer.ln_eps)

    def embed_text(self, ids: torch.Tensor) -> torch.Tensor:
        """Word plus position embeddings through the shared LayerNorm
        (blip2_qformer.py:81-84)."""
        emb = self.Qformer.bert.embeddings
        x = emb.word_embeddings(ids)
        return self._ln(x + emb.position_embeddings.weight[:ids.shape[1]][None].to(x.dtype))

    def ffn(self, x: torch.Tensor, inter: nn.Module, out: nn.Module) -> torch.Tensor:
        """Post-LN FFN, exact GELU (blip2_qformer.py:87-95)."""
        h = gelu(dense(inter.dense, x), approximate=False)
        return layer_norm(dense(out.dense, h) + x, out.LayerNorm.weight, out.LayerNorm.bias,
                          self.cfg.qformer.ln_eps)

    def encode_text(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The text-only path: self-attention and the text FFN, no cross."""
        q = self.cfg.qformer
        x, bias = self.embed_text(ids), mask_bias(mask)
        for layer in self.layers:
            x = layer.attention(x, x, bias, q.num_heads, q.ln_eps)
            x = self.ffn(x, layer.intermediate, layer.output)
        return x

    def encode_queries(self, image_embeds: torch.Tensor) -> torch.Tensor:
        """The query-only path with cross-attention (the ITC image side)."""
        return self.Qformer(self.query_tokens, image_embeds)

    def multimodal_forward(self, image_embeds: torch.Tensor, ids: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
        """ITM: ``[queries ; text]`` share self-attention; the queries also
        cross-attend the image and take the query FFN, the text the text FFN
        (blip2_qformer.py:117-144). Returns the query outputs."""
        q = self.cfg.qformer
        nq, b = q.num_query_tokens, image_embeds.shape[0]
        queries = self._ln(self.query_tokens.to(image_embeds.dtype).expand(
            b, nq, q.hidden_size))
        x = torch.cat([queries, self.embed_text(ids)], dim=1)
        ones = torch.ones((b, nq), dtype=mask.dtype, device=mask.device)
        bias = mask_bias(torch.cat([ones, mask], dim=1))
        for layer in self.layers:
            x = layer.attention(x, x, bias, q.num_heads, q.ln_eps)
            qpart, tpart = x[:, :nq], x[:, nq:]
            if layer.crossattention is not None:
                qpart = layer.crossattention(qpart, image_embeds, None, q.num_heads, q.ln_eps)
            qpart = self.ffn(qpart, layer.intermediate_query, layer.output_query)
            tpart = self.ffn(tpart, layer.intermediate, layer.output)
            x = torch.cat([qpart, tpart], dim=1)
        return x[:, :nq]

    def itc_sim_matrix(self, image_embeds: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """(N_img, N_txt) float32: the max over the query tokens of the
        query-text cosine (blip2_qformer.py sim_q2t)."""
        img = _proj_norm(self.vision_proj, self.encode_queries(image_embeds))
        txt = _proj_norm(self.text_proj, self.encode_text(ids, mask)[:, 0])
        return torch.einsum("nqd,md->nmq", img, txt).amax(dim=-1)

    def itm_score(self, image_embeds: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
        """(B,) float32 match logit: the mean over the query tokens of the
        ITM head's positive class."""
        out = self.multimodal_forward(image_embeds, ids, mask)
        logits = logits_f32(out, self.itm_head.weight) + self.itm_head.bias.to(torch.float32)
        return logits[..., 1].mean(dim=-1)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, 0.02, gen)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                normal_(mod.weight, 0.02, gen)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        normal_(self.query_tokens, 0.02, gen)


def _proj_norm(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = logits_f32(x, lin.weight) + lin.bias.to(torch.float32)
    return y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)


def build_model(cfg: Blip2QformerConfig, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> Blip2Qformer:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype``, frozen; ``seed`` draws a random init from its own
    ``torch.Generator``, ``seed=None`` leaves the storage for a loader."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Blip2Qformer(cfg).to(dtype)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


@torch.inference_mode()
def compute_sim_matrix(model: Blip2Qformer, image_embeds: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor, k_test: int = 128
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's ``compute_sim_matrix`` (blip2.py:116-229): the ITC
    similarity, then ITM re-scores each image's top ``k_test`` texts and
    each text's top ``k_test`` images; every other entry is -inf. Returns
    (score_i2t, score_t2i) as float32 numpy arrays."""
    from ecoflap_tpu_torch.tasks.retrieval import rerank_pair

    sim = model.itc_sim_matrix(image_embeds, ids, mask).cpu().numpy()
    dev = image_embeds.device

    def itm_match(img_rows, txt_rows):
        img_rows, txt_rows = (torch.from_numpy(np.asarray(r)).to(dev)
                              for r in (img_rows, txt_rows))
        return model.itm_score(image_embeds[img_rows], ids[txt_rows],
                               mask[txt_rows]).cpu().numpy()

    # each side's top k_test clips to its candidates, min(k_test, N_txt) for
    # an image and min(k_test, N_img) for a text, as in the reference
    return rerank_pair(sim, itm_match, k_test)
