"""BLIP-2 FlanT5: frozen EVA ViT -> ln_vision -> Q-Former -> t5_proj ->
[query embeds ; text embeds] -> FlanT5 (port of
``ecoflap_tpu/models/blip2.py`` and ``models/adapters.py``; reference
LAVIS blip2_t5.py:41-172).

The pruned stacks are the ViT blocks (``visual_encoder.blocks``, per-tensor
masks) and the T5 encoder and decoder blocks (``t5_model.{encoder,decoder}
.block``, per-row masks). Activations run in the weight dtype: images and
text embeddings are cast to it, as the reference's autocast runs its towers
in half precision.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models import eva_vit, qformer
from ecoflap_tpu_torch.models import t5 as t5_mod
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.generation import GenerateConfig, t5_generate
from ecoflap_tpu_torch.models.layers import embedding, layer_norm, rms_norm
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter, StackSpec


@dataclass(frozen=True)
class Blip2Config:
    vit: eva_vit.EvaViTConfig
    t5: t5_mod.T5Config
    qformer: qformer.QFormerConfig

    @property
    def num_query_tokens(self) -> int:
        return self.qformer.num_query_tokens


def blip2_flant5xl(img_size: int = 224) -> Blip2Config:
    vit = eva_vit.eva_vit_g(img_size)
    return Blip2Config(vit=vit, t5=t5_mod.flan_t5_xl(),
                       qformer=qformer.QFormerConfig(encoder_width=vit.embed_dim))


def blip2_small(img_size: int = 224) -> Blip2Config:
    """ViT-B/16 + flan-t5-base around the standard Q-Former (no reference
    analogue; the mid-scale preset)."""
    vit = eva_vit.vit_base_config(img_size)
    return Blip2Config(vit=vit, t5=t5_mod.flan_t5_base(),
                       qformer=qformer.QFormerConfig(encoder_width=vit.embed_dim))


def tiny_config(vocab_size: Optional[int] = None) -> Blip2Config:
    vit = eva_vit.tiny_config()
    t5_kw = {} if vocab_size is None else {"vocab_size": vocab_size}
    return Blip2Config(vit=vit, t5=t5_mod.tiny_config(**t5_kw),
                       qformer=qformer.tiny_config(encoder_width=vit.embed_dim))


class Blip2T5(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = eva_vit.EvaViT(cfg.vit)
        self.ln_vision = nn.LayerNorm(cfg.vit.embed_dim, eps=1e-5)
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_tokens, cfg.qformer.hidden_size))
        self.Qformer = qformer.QFormer(cfg.qformer)
        self.t5_proj = nn.Linear(cfg.qformer.hidden_size, cfg.t5.d_model)
        self.t5_model = t5_mod.T5Model(cfg.t5)

    def project_features(self, feats: torch.Tensor) -> torch.Tensor:
        """ViT tokens -> (B, num_query_tokens, d_t5) projected queries."""
        feats = layer_norm(feats, self.ln_vision.weight, self.ln_vision.bias, 1e-5)
        q = self.Qformer(self.query_tokens, feats)
        return F.linear(q, self.t5_proj.weight, self.t5_proj.bias)

    def encoder_inputs(self, images, text_ids, text_mask
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[query embeds ; text embeds] and the fused attention mask."""
        q = self.project_features(self.visual_encoder.forward_features(images))
        text = embedding(text_ids, self.t5_model.shared).to(q.dtype)
        q_mask = torch.ones(q.shape[:2], dtype=text_mask.dtype, device=q.device)
        return torch.cat([q, text], dim=1), torch.cat([q_mask, text_mask], dim=1)

    def per_sample_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) LM loss, the ``loss_vision_language`` calibration loss."""
        x, mask = self.encoder_inputs(batch["image"], batch["text_input_ids"],
                                      batch["text_input_mask"])
        return self.t5_model.per_sample_loss(x, mask, batch["labels"])

    @torch.inference_mode()
    def generate(self, images: torch.Tensor, prompt_ids: torch.Tensor,
                 prompt_mask: torch.Tensor, gen: Optional[GenerateConfig] = None,
                 use_beam: bool = True) -> torch.Tensor:
        """(B, max_new_tokens) generated token ids on the device
        (blip2.py:153-178; reference blip2_t5.py:283-340, predict_answers
        :371-431): the encoder over [query embeds ; prompt embeds], then the
        decode loop."""
        if gen is None:
            gen = GenerateConfig(max_new_tokens=30, num_beams=5)
        x, mask = self.encoder_inputs(images, prompt_ids, prompt_mask)
        enc_out = self.t5_model.encode_embeds(x, mask)
        return t5_generate(self.t5_model, enc_out, mask, gen, use_beam)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.visual_encoder.init_(gen)
        self.ln_vision.weight.fill_(1.0)
        self.ln_vision.bias.zero_()
        self.Qformer.init_(gen)
        normal_(self.query_tokens, 0.02, gen)
        normal_(self.t5_proj.weight, 0.02, gen)
        self.t5_proj.bias.zero_()
        self.t5_model.init_(gen)


def config_for_scale(scale: str, vocab_size: Optional[int] = None) -> Blip2Config:
    """The CLIs' ``--model_scale``: ``full`` EVA ViT-g + FlanT5-XL, ``small``
    ViT-B + flan-t5-base, ``tiny`` the test shapes (``vocab_size`` sets
    tiny's T5 vocab)."""
    if scale == "full":
        return blip2_flant5xl()
    if scale == "small":
        return blip2_small()
    return tiny_config(vocab_size)


def build_model(cfg: Blip2Config, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> Blip2T5:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype``, with frozen weights. ``seed`` draws a random init from its own
    ``torch.Generator``; ``seed=None`` leaves the storage uninitialised for a
    loader to fill."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Blip2T5(cfg).to(dtype)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


# -- pruning adapter (BLIPT5 orchestrator, wanda_pruner.py:660-876) ------------

def make_adapter(model: Blip2T5) -> ModelAdapter:
    cfg = model.cfg

    def vit_prepare(m, batch):
        return m.visual_encoder.embed(batch["image"]), None

    def enc_prepare(m, batch):
        x, mask = m.encoder_inputs(batch["image"], batch["text_input_ids"],
                                   batch["text_input_mask"])
        return x, m.t5_model.encoder_bias(mask, x.shape[1])

    def dec_prepare(m, batch):
        x, mask = m.encoder_inputs(batch["image"], batch["text_input_ids"],
                                   batch["text_input_mask"])
        enc_out = m.t5_model.encode_embeds(x, mask)
        return m.t5_model.decoder_inputs(batch["labels"], enc_out, mask)

    def block_forward(block, x, cache, collect=None):
        return block(x, cache, collect=collect)

    stacks = [
        StackSpec("visual_encoder.blocks", cfg.vit.depth, eva_vit.LINEAR_NAMES,
                  False, vit_prepare, block_forward,
                  lambda m: m.visual_encoder.blocks),
        StackSpec("t5_model.encoder.block", cfg.t5.num_layers,
                  t5_mod.ENCODER_LINEARS, True, enc_prepare, block_forward,
                  lambda m: m.t5_model.encoder.block),
        StackSpec("t5_model.decoder.block", cfg.t5.num_decoder_layers,
                  t5_mod.DECODER_LINEARS, True, dec_prepare, block_forward,
                  lambda m: m.t5_model.decoder.block),
    ]

    def build_mezo_plans(m, batch):
        """Suffix plans for every stack (blip2.py:224-274): a perturbation in
        block i cannot change block i's input, so each plan rolls a cache of
        block inputs and evaluates blocks >= i plus the downstream tail."""
        from ecoflap_tpu_torch.pruning.plans import SuffixPlan

        def vit_finish(mm, y, d):
            q = mm.project_features(y)
            text = embedding(d["text_input_ids"], mm.t5_model.shared)
            x = torch.cat([q.to(text.dtype), text], dim=1)
            q_mask = torch.ones(q.shape[:2], dtype=d["text_input_mask"].dtype,
                                device=q.device)
            mask = torch.cat([q_mask, d["text_input_mask"]], dim=1)
            return mm.t5_model.per_sample_loss(x, mask, d["labels"])

        def enc_finish(mm, y, d):
            enc_out = rms_norm(y, mm.t5_model.encoder.final_layer_norm.weight,
                               cfg.t5.ln_eps)
            return mm.t5_model.loss_from_enc(enc_out, d["enc_mask"], d["labels"])

        def dec_finish(mm, y, d):
            return mm.t5_model.loss_from_dec_hidden(y, d["labels"])

        mask = batch["text_input_mask"]
        q_mask = torch.ones((mask.shape[0], cfg.num_query_tokens),
                            dtype=mask.dtype, device=mask.device)
        enc_mask = torch.cat([q_mask, mask], dim=1)
        return [
            SuffixPlan(stacks[0], vit_finish, m, batch,
                       batch_keys=("text_input_ids", "text_input_mask", "labels")),
            SuffixPlan(stacks[1], enc_finish, m, batch, batch_keys=("labels",),
                       extra_data={"enc_mask": enc_mask}),
            SuffixPlan(stacks[2], dec_finish, m, batch, batch_keys=("labels",)),
        ]

    return ModelAdapter(
        name="blip2_t5",
        model=model,
        loss_fn=lambda m, batch: m.per_sample_loss(batch),
        stacks=stacks,
        build_mezo_plans=build_mezo_plans,
        # blip2.py:281-285: both T5 stacks belong to one submodel
        model_prefixes={stacks[0].name: "visual_encoder",
                        stacks[1].name: "t5_model", stacks[2].name: "t5_model"},
    )
