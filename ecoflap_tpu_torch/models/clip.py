"""CLIP: OpenAI CLIP as vendored by CoOp (CoOp/clip/model.py) and EVA-CLIP
(LAVIS/lavis/models/clip_models/eva_model.py), as one module (port of
``ecoflap_tpu/models/clip.py``).

Towers:
* the resblock stack (``ResidualAttentionBlock``), OpenAI's visual tower and
  both text towers: ``ln_1 -> attn (in_proj, out_proj) -> ln_2 -> mlp
  (c_fc, act, c_proj)``. ``attn.in_proj`` is a plain fused-qkv linear, so a
  sparsity key reads ``transformer.resblocks.3.attn.in_proj.weight`` as the
  reference's rebuilt attention names it
  (CoOp/trainers/pruners/wanda_pruner.py:300-322), while the state dict
  keeps ``nn.MultiheadAttention``'s ``attn.in_proj_weight`` and
  ``attn.in_proj_bias``: a ``.pth`` reads and writes under OpenAI's names.
* EVA-CLIP's visual tower is ``eva_vit.EvaViT`` with its final norm and head
  (EVA-CLIP-g.json: 40 blocks, width 1408, head 1024).

The text tower's causal mask rides as an additive bias through the naive
attention, never the flash kernel.

Losses:
* ``contrastive_loss``: symmetric InfoNCE (CoOp/trainers/zsclip.py:73-93).
  A sample's value depends on its whole microbatch (in-batch negatives); the
  port evaluates every calibration loss on whole microbatches and never cuts
  one, so the JAX package's ``chunk_safe=False`` holds without a flag.
* ``zero_shot_ce_loss``: CE of the image features against a prompt-ensemble
  classifier, LAVIS's ``loss_vision`` (compression/pruners/utils.py:37-57).

The zero-shot classifier follows eva_model.py:530-544: every template of a
class encoded, normalised, mean-pooled and normalised again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models import eva_vit
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.layers import (
    attention,
    collect_stats,
    dense,
    embedding,
    extract_patches,
    gelu,
    layer_norm,
)
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter, StackSpec

RESBLOCK_LINEARS = ("attn.in_proj", "attn.out_proj", "mlp.c_fc", "mlp.c_proj")


@dataclass(frozen=True)
class TowerConfig:
    width: int
    layers: int
    heads: int
    act: str = "quick_gelu"  # OpenAI CLIP; EVA-CLIP's text tower "gelu"
    ln_eps: float = 1e-5

    @property
    def mlp_hidden(self) -> int:
        return 4 * self.width


@dataclass(frozen=True)
class CLIPVisualConfig(TowerConfig):
    patch_size: int = 16
    img_size: int = 224
    embed_dim: int = 512

    @property
    def seq_len(self) -> int:
        return (self.img_size // self.patch_size) ** 2 + 1


@dataclass(frozen=True)
class CLIPTextConfig(TowerConfig):
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512


@dataclass(frozen=True)
class CLIPConfig:
    visual: Optional[CLIPVisualConfig]  # None when the visual tower is EVA
    text: CLIPTextConfig
    eva_visual: Optional[eva_vit.EvaViTConfig] = None  # EVA-CLIP

    @property
    def embed_dim(self) -> int:
        return self.text.embed_dim

    @property
    def img_size(self) -> int:
        return (self.eva_visual or self.visual).img_size


def vit_b16(img_size: int = 224) -> CLIPConfig:
    """OpenAI CLIP ViT-B/16 (CoOp/clip/model.py build_model shapes)."""
    return CLIPConfig(
        visual=CLIPVisualConfig(width=768, layers=12, heads=12, patch_size=16,
                                img_size=img_size, embed_dim=512),
        text=CLIPTextConfig(width=512, layers=12, heads=8, embed_dim=512))


def eva_clip_g(img_size: int = 224) -> CLIPConfig:
    """EVA-CLIP-g (EVA-CLIP-g.json)."""
    return CLIPConfig(
        visual=None,
        text=CLIPTextConfig(width=768, layers=12, heads=12, embed_dim=1024, act="gelu"),
        eva_visual=eva_vit.eva_clip_g_visual(img_size=img_size, embed_dim=1024))


def small_config(eva: bool = False, img_size: int = 224) -> CLIPConfig:
    """Mid-scale CLIP (``--model_scale small``): a ViT-B-sized visual tower
    and a 6-layer text tower; no reference analogue."""
    text = CLIPTextConfig(width=512, layers=6, heads=8, embed_dim=512,
                          act="gelu" if eva else "quick_gelu")
    if eva:
        return CLIPConfig(visual=None, text=text, eva_visual=eva_vit.vit_base_config(
            img_size, final_norm=True, head_dim=512))
    return CLIPConfig(
        visual=CLIPVisualConfig(width=768, layers=12, heads=12, patch_size=16,
                                img_size=img_size, embed_dim=512),
        text=text)


def tiny_config(eva: bool = False) -> CLIPConfig:
    text = CLIPTextConfig(width=32, layers=2, heads=4, vocab_size=64, context_length=12,
                          embed_dim=16, act="gelu" if eva else "quick_gelu")
    if eva:
        return CLIPConfig(visual=None, text=text, eva_visual=eva_vit.tiny_config(
            final_norm=True, head_dim=16))
    return CLIPConfig(
        visual=CLIPVisualConfig(width=32, layers=2, heads=4, patch_size=4, img_size=16,
                                embed_dim=16),
        text=text)


def config_for_scale(scale: str, eva: bool) -> CLIPConfig:
    """The CLIs' ``--model_scale``: ``full`` EVA-CLIP-g or ViT-B/16, ``small``
    the mid-scale preset, ``tiny`` the test shapes."""
    if scale == "full":
        return eva_clip_g() if eva else vit_b16()
    if scale == "small":
        return small_config(eva=eva)
    return tiny_config(eva=eva)


# -- the resblock stack -------------------------------------------------------------

def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's x sigmoid(1.702 x) (CoOp/clip/model.py QuickGELU)."""
    return x * torch.sigmoid(1.702 * x)


def _save_in_proj(module, state, prefix, local_metadata):
    """State dict under ``nn.MultiheadAttention``'s names."""
    for p in ("weight", "bias"):
        state[f"{prefix}in_proj_{p}"] = state.pop(f"{prefix}in_proj.{p}")
    return state


def _load_in_proj(state, prefix, *args):
    for p in ("weight", "bias"):
        if f"{prefix}in_proj_{p}" in state:
            state[f"{prefix}in_proj.{p}"] = state.pop(f"{prefix}in_proj_{p}")


class ResAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.in_proj = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        self._register_state_dict_hook(_save_in_proj)
        self._register_load_state_dict_pre_hook(_load_in_proj)


class ResMlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(d, hidden)
        self.c_proj = nn.Linear(hidden, d)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.attn = ResAttention(cfg.width)
        self.ln_2 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.mlp = ResMlp(cfg.width, cfg.mlp_hidden)

    def forward(self, x: torch.Tensor, cache=None, collect: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One block (clip.py:185-225); ``cache`` is the additive attention
        bias (the causal mask for text, None for vision)."""
        cfg, a, m = self.cfg, self.attn, self.mlp
        stats: Dict[str, torch.Tensor] = {}
        h = layer_norm(x, self.ln_1.weight, self.ln_1.bias, cfg.ln_eps)
        q, k, v = dense(a.in_proj, h, name="attn.in_proj", stats=stats,
                        collect=collect).chunk(3, dim=-1)
        o = attention(q, k, v, cfg.heads, bias=cache)
        x = x + dense(a.out_proj, o, name="attn.out_proj", stats=stats, collect=collect)
        h = layer_norm(x, self.ln_2.weight, self.ln_2.bias, cfg.ln_eps)
        h = dense(m.c_fc, h, name="mlp.c_fc", stats=stats, collect=collect)
        h = quick_gelu(h) if cfg.act == "quick_gelu" else gelu(h)
        return x + dense(m.c_proj, h, name="mlp.c_proj", stats=stats,
                         collect=collect), stats


class Transformer(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(cfg)
                                       for _ in range(cfg.layers))

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        for blk in self.resblocks:
            x, _ = blk(x, bias)
        return x


def causal_bias(seq: int, device) -> torch.Tensor:
    """(1, 1, S, S) float32 additive causal mask, -inf above the diagonal
    (layers.py:143-146)."""
    tril = torch.ones(seq, seq, dtype=torch.bool, device=device).tril()
    return torch.where(tril, 0.0, float("-inf")).to(torch.float32)[None, None]


def _init_resblocks(tower: Transformer, cfg: TowerConfig, gen) -> None:
    d, n = cfg.width, cfg.layers
    proj_std = d ** -0.5 * (2 * n) ** -0.5
    for blk in tower.resblocks:
        for ln in (blk.ln_1, blk.ln_2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        for lin, std in ((blk.attn.in_proj, d ** -0.5), (blk.attn.out_proj, proj_std),
                         (blk.mlp.c_fc, (2 * d) ** -0.5), (blk.mlp.c_proj, proj_std)):
            normal_(lin.weight, std, gen)
            lin.bias.zero_()


# -- towers --------------------------------------------------------------------

class VisualTransformer(nn.Module):
    """OpenAI's visual tower: conv1 (no bias) as one matmul over patches, cls
    token, position embedding, ``ln_pre``, resblocks, ``ln_post`` on the cls
    token, ``proj``."""

    def __init__(self, cfg: CLIPVisualConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.width
        self.conv1 = nn.Conv2d(3, d, cfg.patch_size, cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, d))
        self.ln_pre = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.transformer = Transformer(cfg)
        self.ln_post = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.proj = nn.Parameter(torch.empty(d, cfg.embed_dim))

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, N+1, D) tokens after ``ln_pre``."""
        cfg, w = self.cfg, self.conv1.weight
        patches = extract_patches(images.to(w.dtype), cfg.patch_size)
        x = F.linear(patches, w.reshape(w.shape[0], -1))
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        return layer_norm(x, self.ln_pre.weight, self.ln_pre.bias, cfg.ln_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.transformer(self.embed(images), None)
        x = layer_norm(x[:, 0], self.ln_post.weight, self.ln_post.bias, self.cfg.ln_eps)
        return x @ self.proj

    @torch.no_grad()
    def init_(self, gen) -> None:
        d = self.cfg.width
        normal_(self.conv1.weight, d ** -0.5, gen)
        normal_(self.class_embedding, d ** -0.5, gen)
        normal_(self.positional_embedding, d ** -0.5, gen)
        for ln in (self.ln_pre, self.ln_post):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        _init_resblocks(self.transformer, self.cfg, gen)
        normal_(self.proj, d ** -0.5, gen)


class CLIP(nn.Module):
    """The visual tower under ``visual.`` and the text tower at the top
    level, OpenAI's state-dict names (``token_embedding``,
    ``positional_embedding``, ``transformer.resblocks``, ``ln_final``,
    ``text_projection``, ``logit_scale``). ``logit_scale`` stays float32
    whatever the weights' dtype, as the JAX ``init_params`` keeps it."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        self.visual = (eva_vit.EvaViT(cfg.eva_visual) if cfg.eva_visual is not None
                       else VisualTransformer(cfg.visual))
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
        self.transformer = Transformer(t)
        self.ln_final = nn.LayerNorm(t.width, eps=t.ln_eps)
        self.text_projection = nn.Parameter(torch.empty(t.width, t.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, embed) features."""
        return self.visual(images)

    def text_embed(self, ids: torch.Tensor) -> torch.Tensor:
        x = embedding(ids, self.token_embedding)
        return x + self.positional_embedding[: x.shape[1]].to(x.dtype)

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, ctx) token ids -> (B, embed) features, pooled at the argmax id
        (the EOT token; eva_model.py:295-305)."""
        t = self.cfg.text
        x = self.text_embed(ids)
        x = self.transformer(x, causal_bias(x.shape[1], x.device))
        x = layer_norm(x, self.ln_final.weight, self.ln_final.bias, t.ln_eps)
        x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return x @ self.text_projection

    def logits(self, images: torch.Tensor, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits_per_image, logits_per_text), float32, scaled."""
        img = normalize(self.encode_image(images)).to(torch.float32)
        txt = normalize(self.encode_text(ids)).to(torch.float32)
        per_image = self.logit_scale.to(torch.float32).exp() * (img @ txt.T)
        return per_image, per_image.T

    def contrastive_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) per-sample symmetric InfoNCE (zsclip.py:84-90); the mean over
        the batch is the reference's scalar loss."""
        per_image, per_text = self.logits(batch["image"], batch["text_ids"])
        li = -torch.diagonal(torch.log_softmax(per_image, dim=-1))
        lt = -torch.diagonal(torch.log_softmax(per_text, dim=-1))
        return (li + lt) / 2.0

    def predict(self, images: torch.Tensor, classifier: torch.Tensor) -> torch.Tensor:
        """100 img_features @ classifier, float32 (eva_model.py:512-521)."""
        img = normalize(self.encode_image(images)).to(torch.float32)
        return 100.0 * (img @ classifier.to(torch.float32))

    def zero_shot_ce_loss(self, batch: Dict[str, torch.Tensor],
                          classifier: torch.Tensor) -> torch.Tensor:
        """(B,) LAVIS ``loss_vision``: CE of predict / 100 against the labels."""
        lg = self.predict(batch["image"], classifier) / 100.0
        logp = torch.log_softmax(lg, dim=-1)
        return -logp.gather(-1, batch["label"][:, None].long())[:, 0]

    @torch.no_grad()
    def zero_shot_classifier(self, prompt_ids: torch.Tensor, num_classes: int,
                             chunk: int = 4096) -> torch.Tensor:
        """(C*T, ctx) prompts, T templates per class, class-major -> (embed,
        C) classifier (eva_model.py:530-544). The prompts are encoded
        ``chunk`` at a time: a prompt's features do not depend on the
        others."""
        feats = torch.cat([normalize(self.encode_text(prompt_ids[i:i + chunk]))
                           for i in range(0, prompt_ids.shape[0], chunk)])
        feats = feats.reshape(num_classes, -1, feats.shape[-1]).mean(dim=1)
        return normalize(feats).T

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Seeded random init with the JAX ``init_params`` stds."""
        t = self.cfg.text
        self.visual.init_(gen)
        normal_(self.token_embedding.weight, 0.02, gen)
        normal_(self.positional_embedding, 0.01, gen)
        _init_resblocks(self.transformer, t, gen)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        normal_(self.text_projection, t.width ** -0.5, gen)
        self.logit_scale.fill_(torch.log(torch.tensor(1.0 / 0.07)).item())


def normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| with the norm in float32, cast back to x's dtype."""
    return x / torch.linalg.vector_norm(x.to(torch.float32), dim=-1,
                                        keepdim=True).to(x.dtype)


def build_model(cfg: CLIPConfig, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> CLIP:
    """Allocate the model on ``device`` (the card unless ``"cpu"``) in
    ``dtype`` (``logit_scale`` float32), with frozen weights; ``seed`` draws a
    random init from its own ``torch.Generator``, ``seed=None`` leaves the
    storage for a loader."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = CLIP(cfg).to(dtype)
        model.logit_scale.data = model.logit_scale.data.to(torch.float32)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


# -- pruning adapters (clip.py:397-463) ----------------------------------------------

def _block_forward(block, x, cache, collect=None):
    return block(x, cache, collect=collect)


def make_visual_stack(cfg: CLIPConfig) -> StackSpec:
    """``visual.blocks`` (EVA, per-tensor masks) or
    ``visual.transformer.resblocks`` (OpenAI, per-row masks)."""
    if cfg.eva_visual is not None:
        return StackSpec("visual.blocks", cfg.eva_visual.depth, eva_vit.LINEAR_NAMES,
                         False, lambda m, b: (m.visual.embed(b["image"]), None),
                         _block_forward, lambda m: m.visual.blocks)
    return StackSpec("visual.transformer.resblocks", cfg.visual.layers,
                     RESBLOCK_LINEARS, True,
                     lambda m, b: (m.visual.embed(b["image"]), None),
                     _block_forward, lambda m: m.visual.transformer.resblocks)


def make_text_stack(cfg: CLIPConfig) -> StackSpec:
    def prepare(m, batch):
        x = m.text_embed(batch["text_ids"])
        return x, causal_bias(x.shape[1], x.device)

    return StackSpec("transformer.resblocks", cfg.text.layers, RESBLOCK_LINEARS, True,
                     prepare, _block_forward, lambda m: m.transformer.resblocks)


def make_adapter(model: CLIP, include_text: bool = True,
                 classifier: Optional[torch.Tensor] = None) -> ModelAdapter:
    """The CoOp adapter: the visual and text stacks and the contrastive
    calibration loss (zsclip.py:61-93). With ``classifier``, LAVIS's
    EVA-CLIP path: the visual stack alone and the zero-shot CE loss. No
    suffix plans: MeZO scores every target by the serial in-place cycle."""
    cfg = model.cfg
    stacks = [make_visual_stack(cfg)]
    prefixes = {stacks[0].name: "visual"}
    if include_text and classifier is None:
        stacks.append(make_text_stack(cfg))
        prefixes[stacks[1].name] = "transformer"

    if classifier is not None:
        def loss_fn(m, batch: Any):
            return m.zero_shot_ce_loss(batch, classifier)
    else:
        def loss_fn(m, batch: Any):
            return m.contrastive_loss(batch)

    return ModelAdapter(name="eva_clip" if cfg.eva_visual is not None else "clip",
                        model=model, loss_fn=loss_fn, stacks=stacks,
                        model_prefixes=prefixes)
