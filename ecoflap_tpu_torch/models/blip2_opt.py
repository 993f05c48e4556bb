"""BLIP-2 OPT: frozen EVA ViT -> ln_vision -> Q-Former -> opt_proj ->
[query embeds ; prompt embeds] -> frozen OPT decoder (port of
``ecoflap_tpu/models/blip2_opt.py``; reference LAVIS blip2_opt.py: the query
embeds prepended to the prompt, the LM loss on the text only).

The state dict is the reference's (``visual_encoder.*``, ``ln_vision.*``,
``query_tokens``, ``Qformer.bert.*``, ``opt_proj.*``,
``opt_model.model.decoder.*``; the tied ``opt_model.lm_head.weight`` is
left out, as the model reads ``embed_tokens``). The pruning surface is
BLIP-2 FlanT5's shape: ``visual_encoder.blocks`` (per-tensor) and
``opt_model.model.decoder.layers`` (per-row); the MeZO stage scores the OPT
targets by a ``LossPlan`` from the query embeds, computed once (the JAX
adapter's ``make_chunked_loss`` has no counterpart: the port computes them
in one pass).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models import eva_vit, qformer
from ecoflap_tpu_torch.models import opt as opt_mod
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.generation import GenerateConfig
from ecoflap_tpu_torch.models.layers import embedding, layer_norm
from ecoflap_tpu_torch.pruning.adapter import LossPlan, ModelAdapter, StackSpec


@dataclass(frozen=True)
class Blip2OptConfig:
    vit: eva_vit.EvaViTConfig
    opt: opt_mod.OPTConfig
    qformer: qformer.QFormerConfig

    @property
    def num_query_tokens(self) -> int:
        return self.qformer.num_query_tokens


def blip2_opt2_7b(img_size: int = 224) -> Blip2OptConfig:
    """EVA ViT-g (39 x 1408), the Q-Former, OPT-2.7B (32 x 2560)."""
    vit = eva_vit.eva_vit_g(img_size)
    return Blip2OptConfig(vit=vit, opt=opt_mod.opt_2_7b(),
                          qformer=qformer.QFormerConfig(encoder_width=vit.embed_dim))


def tiny_config() -> Blip2OptConfig:
    vit = eva_vit.tiny_config()
    return Blip2OptConfig(vit=vit, opt=opt_mod.tiny_config(),
                          qformer=qformer.tiny_config(encoder_width=vit.embed_dim))


class Blip2OPT(nn.Module):
    def __init__(self, cfg: Blip2OptConfig):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = eva_vit.EvaViT(cfg.vit)
        self.ln_vision = nn.LayerNorm(cfg.vit.embed_dim, eps=1e-5)
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_tokens, cfg.qformer.hidden_size))
        self.Qformer = qformer.QFormer(cfg.qformer)
        self.opt_proj = nn.Linear(cfg.qformer.hidden_size, cfg.opt.d_model)
        self.opt_model = opt_mod.OPTForCausalLM(cfg.opt)

    def project_features(self, feats: torch.Tensor) -> torch.Tensor:
        """ViT tokens -> (B, num_query_tokens, d_opt) query embeds."""
        feats = layer_norm(feats, self.ln_vision.weight, self.ln_vision.bias, 1e-5)
        q = self.Qformer(self.query_tokens, feats)
        return F.linear(q, self.opt_proj.weight, self.opt_proj.bias)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> query embeds (blip2_opt.py:72-82)."""
        return self.project_features(self.visual_encoder.forward_features(images))

    def decoder_inputs(self, query_embeds: torch.Tensor, text_ids: torch.Tensor,
                       text_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[queries ; text] embeds and their joint mask (blip2_opt.py:85-100):
        the queries take positions 0..nq-1 and the text's positions restart
        at 0."""
        opt = self.opt_model
        text = embedding(text_ids, opt.decoder.embed_tokens)
        text = text + opt.position_embeds(opt_mod.positions_of(text_mask), text.dtype)
        nq = query_embeds.shape[1]
        qpos = torch.arange(nq, device=query_embeds.device)[None]
        q = query_embeds + opt.position_embeds(qpos, query_embeds.dtype)
        x = torch.cat([q, text.to(q.dtype)], dim=1)
        ones = torch.ones((x.shape[0], nq), dtype=text_mask.dtype, device=text_mask.device)
        return x, torch.cat([ones, text_mask], dim=1)

    def text_loss(self, query_embeds: torch.Tensor, text_ids: torch.Tensor,
                  text_mask: torch.Tensor) -> torch.Tensor:
        """(B,) LM loss over the text tokens only, from the query embeds
        (blip2_opt.py:142-168): logit t-1 predicts text token t."""
        x, mask = self.decoder_inputs(query_embeds, text_ids, text_mask)
        bias = opt_mod.causal_mask_bias(mask, x.shape[1], x.device)
        logits = self.opt_model.forward_embeds(x, bias)
        nq = query_embeds.shape[1]
        logp = torch.log_softmax(logits[:, nq - 1:-1], dim=-1)
        ce = -logp.gather(-1, text_ids[..., None].long())[..., 0]
        valid = text_mask > 0
        ce = torch.where(valid, ce, torch.zeros_like(ce))
        return ce.sum(-1) / valid.sum(-1).clamp(min=1)

    def per_sample_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.text_loss(self.encode_image(batch["image"]), batch["text_ids"],
                              batch["text_mask"])

    @torch.inference_mode()
    def generate(self, images: torch.Tensor, prompt_ids: torch.Tensor,
                 prompt_mask: torch.Tensor, gen: Optional[GenerateConfig] = None,
                 use_beam: bool = True) -> torch.Tensor:
        """(B, max_new_tokens) tokens (blip2_opt.py:103-139; reference
        blip2_opt.py:154-236). Prompts are unpadded and of one length: the
        prefix is [queries ; prompt without its last token], which is fed
        first at position t - 1; ``len_offset`` t - 1 makes HF's
        ``min_length`` count the prompt's tokens and not the queries."""
        if gen is None:
            gen = GenerateConfig(max_new_tokens=30, num_beams=5, min_length=8)
        c = self.cfg.opt
        gen = dataclasses.replace(gen, eos_token_id=c.eos_token_id,
                                  pad_token_id=c.pad_token_id)
        x, mask = self.decoder_inputs(self.encode_image(images), prompt_ids, prompt_mask)
        t = prompt_ids.shape[1]
        return opt_mod.generate_from_embeds(
            self.opt_model, x[:, :-1], mask[:, :-1], prompt_ids[:, -1], gen, use_beam,
            pos0=t - 1, len_offset=t - 1, prompt_tokens=prompt_ids)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.visual_encoder.init_(gen)
        self.ln_vision.weight.fill_(1.0)
        self.ln_vision.bias.zero_()
        self.Qformer.init_(gen)
        normal_(self.query_tokens, 0.02, gen)
        normal_(self.opt_proj.weight, 0.02, gen)
        self.opt_proj.bias.zero_()
        self.opt_model.init_(gen)


def config_for_scale(scale: str) -> Blip2OptConfig:
    """``full`` BLIP-2 OPT-2.7B, ``tiny`` the test shapes; there is no
    mid-scale preset: ``small`` ends the run, as the JAX CLI's ``_pick``
    does (cli/evaluate.py:158-168)."""
    if scale == "full":
        return blip2_opt2_7b()
    if scale == "small":
        raise SystemExit("--model_scale small: no mid-scale preset for blip2_opt; "
                         "use tiny or full")
    return tiny_config()


def build_model(cfg: Blip2OptConfig, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> Blip2OPT:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype``, frozen; ``seed`` draws a random init from its own
    ``torch.Generator``, ``seed=None`` leaves the storage for a loader."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Blip2OPT(cfg).to(dtype)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


def _block_forward(block, x, cache, collect=None):
    return block(x, cache, collect=collect)


def make_adapter(model: Blip2OPT) -> ModelAdapter:
    """The ViT and OPT stacks on the text LM loss (blip2_opt.py:171-249);
    the MeZO stage scores the OPT targets from the query embeds of the
    unperturbed ViT and Q-Former (a ``LossPlan``)."""
    cfg = model.cfg

    def opt_prepare(m, batch):
        x, mask = m.decoder_inputs(m.encode_image(batch["image"]), batch["text_ids"],
                                   batch["text_mask"])
        return x, opt_mod.causal_mask_bias(mask, x.shape[1], x.device)

    stacks = [
        StackSpec("visual_encoder.blocks", cfg.vit.depth, eva_vit.LINEAR_NAMES, False,
                  lambda m, b: (m.visual_encoder.embed(b["image"]), None), _block_forward,
                  lambda m: m.visual_encoder.blocks),
        opt_mod.make_stack(cfg.opt, "opt_model.model.decoder.layers",
                           lambda m: m.opt_model.decoder.layers, opt_prepare),
    ]

    def plans(m, batch):
        data = {**batch, "query_embeds": m.encode_image(batch["image"])}
        return [LossPlan(
            match=lambda name: name.startswith("opt_model."),
            loss_fn=lambda mm, b: mm.text_loss(b["query_embeds"], b["text_ids"],
                                               b["text_mask"]),
            data=data)]

    return ModelAdapter(
        name="blip2_opt", model=model, loss_fn=lambda m, b: m.per_sample_loss(b),
        stacks=stacks, build_mezo_plans=plans,
        model_prefixes={stacks[0].name: "visual_encoder", stacks[1].name: "opt_model"})
