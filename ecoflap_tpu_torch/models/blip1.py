"""BLIP-1, the UPop runs' model family (port of ``ecoflap_tpu/models/blip1.py``;
reference UPop/models/blip.py, blip_vqa.py, blip_retrieval.py, blip_nlvr.py
and nlvr_encoder.py).

Four heads around one ViT-B/16 (``eva_vit`` with a full fused qkv bias and
``norm`` applied to every token, BLIP's convention):

* ``blip_caption``: the causal BERT ``text_decoder`` (cross-attention to the
  image tokens on every layer, LM head), next-token CE over the caption;
  ``generate`` decodes from the prompt "a picture of" (``bert_generate``);
* ``blip_vqa``: the question ``text_encoder`` (bidirectional, cross to the
  image) and the answer ``text_decoder`` (cross to the question states);
  ``rank_answers`` is the reference's rank inference;
* ``blip_retrieval``: the ``text_encoder`` with ITM (cross to the image,
  ``itm_head`` on [CLS]) and ITC (``vision_proj``/``text_proj``);
* ``blip_nlvr``: the ``text_encoder`` whose cross-attention runs twin
  streams over two images (``self0``/``self1``, ``dense0``/``dense1``),
  averaged below layer ``min(6, L - 1)`` and merged by ``merge_layer`` from
  it (nlvr_encoder.py:239-268), and the 2-way ``cls_head``.

Each module carries the UPop checkpoint's names, so a model's state dict is
what ``export_blip1`` writes for its kind (the averaged layers' unused
``merge_layer`` stays out of it, as the reference has none there). Pruned
stacks (UPop/pruners/wanda_pruner.py:600-823): ``visual_encoder.blocks``
(per-tensor masks) and the BERT towers' ``encoder.layer`` (per-row), with
the reference sparsity-key prefixes (``text_decoder.bert.encoder.layer``,
``text_encoder.encoder.layer``). The caption and retrieval adapters give
the MeZO stage a ``LossPlan``: the text tower's targets score from the
image embeddings, computed once with the unperturbed weights.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models import bert as bert_mod
from ecoflap_tpu_torch.models import eva_vit
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.generation import GenerateConfig, bert_generate, stable_topk
from ecoflap_tpu_torch.models.layers import (
    attention,
    collect_stats,
    dense,
    layer_norm,
    mask_bias,
)
from ecoflap_tpu_torch.pruning.adapter import LossPlan, ModelAdapter, StackSpec

KINDS = ("blip_caption", "blip_vqa", "blip_nlvr", "blip_retrieval")
# the image embeddings of a LossPlan are computed this many samples at a time
PLAN_CHUNK = 8

NLVR_LINEARS = bert_mod.LINEAR_NAMES_NO_CROSS + (
    "crossattention.self0.query", "crossattention.self0.key",
    "crossattention.self0.value",
    "crossattention.self1.query", "crossattention.self1.key",
    "crossattention.self1.value",
    "crossattention.output.dense0", "crossattention.output.dense1",
    "crossattention.output.merge_layer",
)


@dataclass(frozen=True)
class Blip1Config:
    vit: eva_vit.EvaViTConfig
    text: bert_mod.BertConfig
    embed_dim: int = 256  # the ITC space
    prompt_length: int = 0  # caption prompt tokens left out of the loss

    @property
    def encoder_text(self) -> bert_mod.BertConfig:
        """The bidirectional text encoder's config (VQA, retrieval, NLVR)."""
        return dataclasses.replace(self.text, causal=False)


def blip_base(img_size: int = 384) -> Blip1Config:
    """BLIP with ViT-B/16 (blip.py:84-92 defaults)."""
    vit = eva_vit.EvaViTConfig(img_size=img_size, patch_size=16, embed_dim=768, depth=12,
                               num_heads=12, mlp_hidden=3072, final_norm=True,
                               qkv_bias_mode="full")
    text = bert_mod.BertConfig(add_cross_attention=True, causal=True, encoder_width=768)
    return Blip1Config(vit=vit, text=text)


def tiny_config() -> Blip1Config:
    vit = eva_vit.tiny_config(final_norm=True, qkv_bias_mode="full")
    text = bert_mod.tiny_config(add_cross_attention=True, causal=True,
                                encoder_width=vit.embed_dim)
    return Blip1Config(vit=vit, text=text, embed_dim=16)


def config_for_scale(scale: str) -> Blip1Config:
    """``--model_scale``: ``tiny`` the test shapes, else ``blip_base`` (the
    JAX launchers and CLI alias ``small`` to it)."""
    return tiny_config() if scale == "tiny" else blip_base()


def lm_ce(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
          prompt_length: int = 0) -> torch.Tensor:
    """(B,) mean next-token CE over the valid targets (blip1.py:79-89):
    float32 log-softmax, masked and prompt positions left out."""
    targets = ids[:, 1:]
    valid = mask[:, 1:] > 0
    if prompt_length > 1:
        pos = torch.arange(targets.shape[1], device=ids.device)[None]
        valid = valid & (pos >= prompt_length - 1)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    ce = -logp.gather(-1, targets[..., None])[..., 0]
    ce = torch.where(valid, ce, 0.0)
    return ce.sum(-1) / valid.sum(-1).clamp(min=1)


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:2], dtype=torch.long, device=x.device)


def _head(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x W^T + b with float32 output (a ``preferred_element_type=float32``
    dot plus its bias), differentiable in the weight."""
    return bert_mod.widened_linear(x, lin.weight) + lin.bias.to(torch.float32)


class _Blip1(nn.Module):
    """What the four heads share: the ViT and its per-token final norm."""

    kind = ""

    def __init__(self, cfg: Blip1Config):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = eva_vit.EvaViT(cfg.vit)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """Every ViT token through ``norm`` (blip1.py:encode_image)."""
        x = self.visual_encoder.forward_features(images)
        n = self.visual_encoder.norm
        return layer_norm(x, n.weight, n.bias, self.cfg.vit.ln_eps)

    def image_embeds(self, images: torch.Tensor) -> torch.Tensor:
        """``encode_image`` over ``PLAN_CHUNK`` images at a time."""
        return torch.cat([self.encode_image(c) for c in images.split(PLAN_CHUNK)])

    def tie_weights(self) -> None:
        for mod in self.modules():
            if isinstance(mod, bert_mod.BertLMHeadModel):
                mod.tie_weights()

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.visual_encoder.init_(gen)
        for mod in self.children():
            if mod is self.visual_encoder:
                continue
            if isinstance(mod, (bert_mod.BertModel, bert_mod.BertLMHeadModel)):
                mod.init_(gen)
            else:  # the projections and heads
                for lin in mod.modules():
                    if isinstance(lin, nn.Linear):
                        normal_(lin.weight, 0.02, gen)
                        lin.bias.zero_()


class BlipCaption(_Blip1):
    kind = "blip_caption"

    def __init__(self, cfg: Blip1Config):
        super().__init__(cfg)
        self.text_decoder = bert_mod.BertLMHeadModel(cfg.text)
        self.vision_proj = nn.Linear(cfg.vit.embed_dim, cfg.embed_dim)
        self.text_proj = nn.Linear(cfg.text.hidden_size, cfg.embed_dim)

    def caption_loss(self, ids, mask, img) -> torch.Tensor:
        hidden = self.text_decoder(ids, mask, img)
        return lm_ce(self.text_decoder.lm_logits(hidden), ids, mask, self.cfg.prompt_length)

    def per_sample_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) caption LM loss, teacher-forced with cross-attention to the
        image tokens (blip.py:107-134)."""
        return self.caption_loss(batch["caption_ids"], batch["caption_mask"],
                                 self.encode_image(batch["image"]))

    @torch.inference_mode()
    def generate(self, images: torch.Tensor, prompt_ids: torch.Tensor,
                 gen: Optional[GenerateConfig] = None, use_beam: bool = True
                 ) -> torch.Tensor:
        """(B, max_new_tokens) caption ids from an unpadded shared prompt
        (blip_caption generate: beam 3, min length 5, max 20)."""
        t = self.cfg.text
        if gen is None:
            gen = GenerateConfig(max_new_tokens=20, num_beams=3, min_length=5)
        gen = dataclasses.replace(gen, eos_token_id=t.sep_token_id,
                                  pad_token_id=t.pad_token_id)
        return bert_generate(self.text_decoder, prompt_ids, self.encode_image(images),
                             gen, use_beam)


class BlipVQA(_Blip1):
    kind = "blip_vqa"

    def __init__(self, cfg: Blip1Config):
        super().__init__(cfg)
        self.text_encoder = bert_mod.BertModel(cfg.encoder_text)
        self.text_decoder = bert_mod.BertLMHeadModel(cfg.text)

    def question_states(self, images, q_ids, q_mask) -> torch.Tensor:
        return self.text_encoder(q_ids, q_mask, self.encode_image(images))

    def vqa_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) answer LM loss given image and question (blip_vqa.py train)."""
        q = self.question_states(batch["image"], batch["question_ids"],
                                 batch["question_mask"])
        hidden = self.text_decoder(batch["answer_ids"], batch["answer_mask"], q,
                                   batch["question_mask"])
        return lm_ce(self.text_decoder.lm_logits(hidden), batch["answer_ids"],
                     batch["answer_mask"])

    per_sample_loss = vqa_loss

    @torch.inference_mode()
    def rank_answers(self, images, q_ids, q_mask, answer_ids, answer_mask,
                     k: int = 128) -> torch.Tensor:
        """(B,) best answer-list indices, the reference's rank inference
        (blip_vqa.py:132-177): a bos-only decoder pass keeps the top ``k``
        candidates by first-token probability, then the decoder scores each
        by its token-sum log-probability. ``answer_ids[:, 0]`` is the bos."""
        dec = self.text_decoder
        q = self.question_states(images, q_ids, q_mask)
        b, n = q_ids.shape[0], answer_ids.shape[0]
        k = min(k, n)
        start = answer_ids[:1, :1].expand(b, 1)
        hidden = dec(start, torch.ones_like(start), q, q_mask)
        first = torch.softmax(dec.lm_logits(hidden)[:, 0], dim=-1)[:, answer_ids[:, 1]]
        _, top = stable_topk(first, k)  # (B, k)
        flat_ids = answer_ids[top].reshape(b * k, -1)
        flat_mask = answer_mask[top].reshape(b * k, -1)
        hidden = dec(flat_ids, flat_mask, q.repeat_interleave(k, 0),
                     q_mask.repeat_interleave(k, 0))
        logp = torch.log_softmax(dec.lm_logits(hidden)[:, :-1], dim=-1)
        lp = logp.gather(-1, flat_ids[:, 1:, None])[..., 0]
        score = torch.where(flat_mask[:, 1:] > 0, lp, 0.0).sum(-1).reshape(b, k)
        best = score.argmax(dim=1)
        return top[torch.arange(b, device=top.device), best]


class BlipRetrieval(_Blip1):
    kind = "blip_retrieval"

    def __init__(self, cfg: Blip1Config):
        super().__init__(cfg)
        self.text_encoder = bert_mod.BertModel(cfg.encoder_text)
        self.vision_proj = nn.Linear(cfg.vit.embed_dim, cfg.embed_dim)
        self.text_proj = nn.Linear(cfg.text.hidden_size, cfg.embed_dim)
        self.itm_head = nn.Linear(cfg.text.hidden_size, 2)

    def itm_from_embeds(self, ids, mask, img) -> torch.Tensor:
        hidden = self.text_encoder(ids, mask, img)
        return _head(self.itm_head, hidden[:, 0])

    def itm_logits(self, images, ids, mask) -> torch.Tensor:
        """(B, 2) float32 image-text matching logits: the text encoder with
        cross-attention to the image, [CLS] through ``itm_head``."""
        return self.itm_from_embeds(ids, mask, self.encode_image(images))

    def per_sample_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """-log p(match) of matched pairs, the UPop retrieval calibration
        loss (wanda_pruner.py:721-750)."""
        logits = self.itm_logits(batch["image"], batch["caption_ids"], batch["caption_mask"])
        return -torch.log_softmax(logits, dim=-1)[:, 1]

    @torch.inference_mode()
    def sim_matrix(self, images, ids, mask) -> torch.Tensor:
        """(N_img, N_txt) ITC cosine similarity, float32: the image [CLS] and
        the text-only pass's [CLS] through their projections, normalised."""
        iv = _head(self.vision_proj, self.encode_image(images)[:, 0])
        tv = _head(self.text_proj, self.text_encoder(ids, mask)[:, 0])
        iv = iv / torch.linalg.vector_norm(iv, dim=-1, keepdim=True)
        tv = tv / torch.linalg.vector_norm(tv, dim=-1, keepdim=True)
        return iv @ tv.T


class NlvrCrossOutput(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.dense0 = nn.Linear(d, d)
        self.dense1 = nn.Linear(d, d)
        self.merge_layer = nn.Linear(2 * d, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class NlvrCross(nn.Module):
    def __init__(self, d: int, kv_width: int, eps: float):
        super().__init__()
        self.self0 = bert_mod.BertSelfAttention(d, kv_width)
        self.self1 = bert_mod.BertSelfAttention(d, kv_width)
        self.output = NlvrCrossOutput(d, eps)


def _drop_unmerged(module, state, prefix, local_metadata):
    """An averaged layer has no ``merge_layer`` in the reference's state."""
    if not module.merge_on:
        for k in [k for k in state if k.startswith(prefix + "crossattention.output."
                                                             "merge_layer.")]:
            del state[k]


class NlvrLayer(bert_mod.BertLayer):
    """The twin-cross BERT layer (nlvr_encoder.py BertAttention/BertSelfOutput):
    stream i runs its own q/k/v against image i and its own output dense;
    the two outputs are averaged, or from layer ``min(6, L - 1)`` on
    concatenated through ``merge_layer``. Every layer keeps a
    ``merge_layer`` (a target of the pruner, as in the JAX package, where
    the averaged layers' is computed and ignored); its statistics are
    collected either way."""

    def __init__(self, cfg: bert_mod.BertConfig, index: int = 0):
        nn.Module.__init__(self)
        self.cfg = cfg
        d = cfg.hidden_size
        self.merge_on = index >= min(6, cfg.num_layers - 1)
        self.attention = bert_mod.BertAttention(d, d, cfg.ln_eps)
        self.crossattention = NlvrCross(d, cfg.encoder_width, cfg.ln_eps)
        self.intermediate = bert_mod.BertIntermediate(d, cfg.intermediate_size)
        self.output = bert_mod.BertOutput(cfg.intermediate_size, d, cfg.ln_eps)
        self._register_state_dict_hook(_drop_unmerged)

    def forward(self, x, cache, collect=None):
        """``cache`` = (self bias, cross bias 0, cross bias 1, image 0, image 1)."""
        self_bias, cb0, cb1, enc0, enc1 = cache
        cfg, cp = self.cfg, self.crossattention
        stats: Dict[str, torch.Tensor] = {}
        x = self.attention(x, x, self_bias, cfg.num_heads, cfg.ln_eps, "attention",
                           stats, collect)

        def stream(which, sa, out, enc, bias):
            kv = enc.to(x.dtype)
            pre = f"crossattention.self{which}"
            collect_stats(stats, f"{pre}.query", x, collect)
            collect_stats(stats, (f"{pre}.key", f"{pre}.value"), kv, collect)
            o = attention(F.linear(x, sa.query.weight, sa.query.bias),
                          F.linear(kv, sa.key.weight, sa.key.bias),
                          F.linear(kv, sa.value.weight, sa.value.bias), cfg.num_heads,
                          bias=bias)
            return dense(out, o, name=f"crossattention.output.dense{which}", stats=stats,
                         collect=collect)

        h0 = stream(0, cp.self0, cp.output.dense0, enc0, cb0)
        h1 = stream(1, cp.self1, cp.output.dense1, enc1, cb1)
        cat = torch.cat([h0, h1], dim=-1)
        collect_stats(stats, "crossattention.output.merge_layer", cat, collect)
        mixed = (F.linear(cat, cp.output.merge_layer.weight, cp.output.merge_layer.bias)
                 if self.merge_on else (h0 + h1) * 0.5)
        ln = cp.output.LayerNorm
        x = layer_norm(mixed + x, ln.weight, ln.bias, cfg.ln_eps)
        return self.ffn(x, stats, collect), stats


class BlipNLVR(_Blip1):
    kind = "blip_nlvr"

    def __init__(self, cfg: Blip1Config):
        super().__init__(cfg)
        d = cfg.text.hidden_size
        self.text_encoder = bert_mod.BertModel(cfg.encoder_text, layer_cls=NlvrLayer)
        self.cls_head = nn.Sequential(nn.Linear(d, d), nn.ReLU(), nn.Linear(d, 2))

    def text_cache(self, batch):
        img0 = self.encode_image(batch["image0"])
        img1 = self.encode_image(batch["image1"])
        return (mask_bias(batch["text_mask"]), mask_bias(_ones(img0)), mask_bias(_ones(img1)),
                img0, img1)

    def nlvr_forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, 2) float32 true/false logits (blip_nlvr.py:44-91)."""
        cache = self.text_cache(batch)
        x = self.text_encoder.embed(batch["text_ids"])
        for layer in self.text_encoder.encoder.layer:
            x, _ = layer(x, cache)
        cls = x[:, 0]
        h = torch.relu(F.linear(cls, self.cls_head[0].weight, self.cls_head[0].bias))
        return _head(self.cls_head[2], h)

    def per_sample_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logp = torch.log_softmax(self.nlvr_forward(batch), dim=-1)
        return -logp.gather(-1, batch["label"][:, None].long())[:, 0]


MODELS = {m.kind: m for m in (BlipCaption, BlipVQA, BlipNLVR, BlipRetrieval)}


def build_model(cfg: Blip1Config, kind: str = "blip_caption", *, device=None,
                dtype=torch.float32, seed: Optional[int] = 0) -> _Blip1:
    """The ``kind`` head on ``device`` (the card unless ``"cpu"``) in
    ``dtype``, frozen; ``seed`` draws a random init from its own generator
    (JAX ``init_params`` stds), ``seed=None`` leaves the storage for a
    loader."""
    if kind not in MODELS:
        raise ValueError(f"unknown BLIP-1 kind {kind!r}; one of {KINDS}")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MODELS[kind](cfg).to(dtype)
    model = model.to_empty(device=dev)
    model.tie_weights()
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


# -- pruning adapters --------------------------------------------------------------

def _block_forward(block, x, cache, collect=None):
    return block(x, cache, collect=collect)


def _vit_stack(cfg: Blip1Config, prepare=None) -> StackSpec:
    if prepare is None:
        def prepare(m, batch):
            return m.visual_encoder.embed(batch["image"]), None
    return StackSpec("visual_encoder.blocks", cfg.vit.depth, eva_vit.LINEAR_NAMES, False,
                     prepare, _block_forward, lambda m: m.visual_encoder.blocks)


def _adapter(model, loss_fn, stacks, prefixes, plans=None) -> ModelAdapter:
    return ModelAdapter(name=model.kind, model=model, loss_fn=loss_fn, stacks=stacks,
                        build_mezo_plans=plans,
                        model_prefixes=dict(zip((s.name for s in stacks), prefixes)))


def make_caption_adapter(model: BlipCaption) -> ModelAdapter:
    cfg = model.cfg

    def text_prepare(m, batch):
        img = m.encode_image(batch["image"])
        x = m.text_decoder.bert.embed(batch["caption_ids"])
        return x, bert_mod.make_cache(cfg.text, batch["caption_mask"], img)

    def plans(m, batch):
        """The text targets' loss from the image embeddings (blip1.py:652-686)."""
        data = {**batch, "image_embeds": m.image_embeds(batch["image"])}
        return [LossPlan(
            match=lambda name: name.startswith("text_decoder."),
            loss_fn=lambda mm, b: mm.caption_loss(b["caption_ids"], b["caption_mask"],
                                                  b["image_embeds"]),
            data=data)]

    stacks = [_vit_stack(cfg), bert_mod.make_bert_stack(
        cfg.text, "text_decoder.bert.encoder.layer", lambda m: m.text_decoder.bert.encoder.layer,
        text_prepare)]
    return _adapter(model, lambda m, b: m.per_sample_loss(b), stacks,
                    ("visual_encoder", "text_decoder"), plans)


def make_vqa_adapter(model: BlipVQA) -> ModelAdapter:
    cfg = model.cfg
    enc_cfg = cfg.encoder_text

    def enc_prepare(m, batch):
        img = m.encode_image(batch["image"])
        x = m.text_encoder.embed(batch["question_ids"])
        return x, bert_mod.make_cache(enc_cfg, batch["question_mask"], img)

    def dec_prepare(m, batch):
        q = m.question_states(batch["image"], batch["question_ids"], batch["question_mask"])
        x = m.text_decoder.bert.embed(batch["answer_ids"])
        return x, bert_mod.make_cache(cfg.text, batch["answer_mask"], q,
                                      batch["question_mask"])

    # the question encoder is a bare BertModel: no ".bert." in its keys
    # (UPop/pruners/wanda_pruner.py:813-818)
    stacks = [
        _vit_stack(cfg),
        bert_mod.make_bert_stack(enc_cfg, "text_encoder.encoder.layer",
                                 lambda m: m.text_encoder.encoder.layer, enc_prepare),
        bert_mod.make_bert_stack(cfg.text, "text_decoder.bert.encoder.layer",
                                 lambda m: m.text_decoder.bert.encoder.layer, dec_prepare),
    ]
    return _adapter(model, lambda m, b: m.per_sample_loss(b), stacks,
                    ("visual_encoder", "text_encoder", "text_decoder"))


def make_retrieval_adapter(model: BlipRetrieval) -> ModelAdapter:
    cfg = model.cfg
    enc_cfg = cfg.encoder_text

    def text_prepare(m, batch):
        img = m.encode_image(batch["image"])
        x = m.text_encoder.embed(batch["caption_ids"])
        return x, bert_mod.make_cache(enc_cfg, batch["caption_mask"], img)

    def plans(m, batch):
        """The ITM loss from the image embeddings (blip1.py:358-389)."""
        data = {**batch, "image_embeds": m.image_embeds(batch["image"])}

        def text_loss(mm, b):
            logits = mm.itm_from_embeds(b["caption_ids"], b["caption_mask"], b["image_embeds"])
            return -torch.log_softmax(logits, dim=-1)[:, 1]

        return [LossPlan(match=lambda name: name.startswith("text_encoder."),
                         loss_fn=text_loss, data=data)]

    stacks = [_vit_stack(cfg), bert_mod.make_bert_stack(
        enc_cfg, "text_encoder.encoder.layer", lambda m: m.text_encoder.encoder.layer,
        text_prepare)]
    return _adapter(model, lambda m, b: m.per_sample_loss(b), stacks,
                    ("visual_encoder", "text_encoder"), plans)


def make_nlvr_adapter(model: BlipNLVR) -> ModelAdapter:
    cfg = model.cfg

    def vit_prepare(m, batch):
        # both images as one doubled batch (blip_nlvr.py:52-55)
        return m.visual_encoder.embed(torch.cat([batch["image0"], batch["image1"]])), None

    def text_prepare(m, batch):
        return m.text_encoder.embed(batch["text_ids"]), m.text_cache(batch)

    stacks = [_vit_stack(cfg, vit_prepare), bert_mod.make_bert_stack(
        cfg.encoder_text, "text_encoder.encoder.layer", lambda m: m.text_encoder.encoder.layer,
        text_prepare, linear_names=NLVR_LINEARS)]
    return _adapter(model, lambda m, b: m.per_sample_loss(b), stacks,
                    ("visual_encoder", "text_encoder"))


ADAPTERS = {"blip_caption": make_caption_adapter, "blip_vqa": make_vqa_adapter,
            "blip_nlvr": make_nlvr_adapter, "blip_retrieval": make_retrieval_adapter}


def make_adapter(model: _Blip1) -> ModelAdapter:
    """The pruning adapter of ``model``'s head."""
    return ADAPTERS[model.kind](model)
