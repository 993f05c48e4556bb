"""Image classifiers, the ``LLaMA/image_classifiers`` family: DeiT and
ConvNeXt (port of ``ecoflap_tpu/models/classifiers.py``; reference
layerwrapper.py:11-53, prune_utils.py:27-226).

* DeiT is the EVA ViT block with timm's full qkv bias, a final LayerNorm on
  the cls token and a linear head to the classes (``eva_vit.EvaViT``); its
  state dict is timm's (``patch_embed.proj``, ``blocks.{i}``, ``norm``,
  ``head``) and its prunable linears are the blocks' four.
* ConvNeXt: per stage a downsample (the 4x4 stem conv and a LayerNorm, or a
  LayerNorm and a 2x2 conv), then blocks of a depthwise 7x7 conv, a
  LayerNorm, ``pwconv1`` / GELU / ``pwconv2`` (1x1 convs, so linears) and
  the layer scale ``gamma``; a LayerNorm of the pooled features and the
  head. The state dict is FB's (``downsample_layers.{s}.{0,1}``,
  ``stages.{s}.{b}.*``, ``norm``, ``head``); the pruned linears are the
  pointwise convs, as in the reference, their sparsity keys
  ``stages.{s}.blocks.{b}.pwconv{1,2}.weight`` (the JAX stacks' names).

Images are NHWC. The stem and downsample convs keep their Conv2d weights
``(out, in, kh, kw)`` and run as one matmul over ``extract_patches``, whose
rows are in the weight's ``(C, ph, pw)`` order; the depthwise conv is
``F.conv2d`` with ``groups=C`` (the JAX package's is
``lax.conv_general_dilated``, outside any Pallas kernel).

Cross-entropy calibration loss: DeiT's logits are in the activation dtype
(the JAX head rounds them to it), ConvNeXt's float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.core.device import resolve_device
from ecoflap_tpu_torch.models import eva_vit
from ecoflap_tpu_torch.models.eva_vit import normal_
from ecoflap_tpu_torch.models.layers import (
    dense,
    extract_patches,
    gelu,
    layer_norm,
    logits_f32,
)
from ecoflap_tpu_torch.pruning.adapter import ModelAdapter, StackSpec

CONVNEXT_LINEARS = ("pwconv1", "pwconv2")


# -- DeiT ----------------------------------------------------------------------------

def deit_base(img_size: int = 224, num_classes: int = 1000) -> eva_vit.EvaViTConfig:
    """DeiT-B/16 (timm deit_base_patch16_224)."""
    return eva_vit.EvaViTConfig(
        img_size=img_size, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        mlp_hidden=3072, final_norm=True, head_dim=num_classes, qkv_bias_mode="full")


def deit_small(img_size: int = 224, num_classes: int = 1000) -> eva_vit.EvaViTConfig:
    """DeiT-S/16 (``--model_scale small``; timm deit_small_patch16_224)."""
    return eva_vit.EvaViTConfig(
        img_size=img_size, patch_size=16, embed_dim=384, depth=12, num_heads=6,
        mlp_hidden=1536, final_norm=True, head_dim=num_classes, qkv_bias_mode="full")


def vit_classifier_loss(model: eva_vit.EvaViT, batch: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
    """(B,) CE of the head's logits, in their dtype (classifiers.py:54-58)."""
    logp = torch.log_softmax(model(batch["image"]), dim=-1)
    return -logp.gather(-1, batch["label"][:, None].long())[:, 0]


def make_vit_classifier_adapter(model: eva_vit.EvaViT) -> ModelAdapter:
    """One stack ``blocks``, per-tensor masks, the CE loss; no suffix plan,
    so MeZO scores every target by the serial in-place cycle."""
    stack = StackSpec("blocks", model.cfg.depth, eva_vit.LINEAR_NAMES, False,
                      lambda m, b: (m.embed(b["image"]), None), _block_forward,
                      lambda m: m.blocks)
    return ModelAdapter(name="vit_classifier", model=model, loss_fn=vit_classifier_loss,
                        stacks=[stack], model_prefixes={"blocks": "blocks"})


# -- ConvNeXt ------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    num_classes: int = 1000
    img_size: int = 224
    ln_eps: float = 1e-6


def convnext_tiny() -> ConvNeXtConfig:
    """ConvNeXt-T (FB convnext_tiny)."""
    return ConvNeXtConfig()


def tiny_config() -> ConvNeXtConfig:
    return ConvNeXtConfig(depths=(2, 2), dims=(16, 32), num_classes=10, img_size=32)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> pwconv1 -> GELU -> pwconv2, times ``gamma``, plus
    the input (classifiers.py:172-184)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, cache=None, collect: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        del cache
        stats: Dict[str, torch.Tensor] = {}
        h = F.conv2d(x.permute(0, 3, 1, 2), self.dwconv.weight, self.dwconv.bias,
                     padding=3, groups=x.shape[-1]).permute(0, 2, 3, 1)
        h = layer_norm(h, self.norm.weight, self.norm.bias, self.eps)
        h = gelu(dense(self.pwconv1, h, name="pwconv1", stats=stats, collect=collect),
                 approximate=False)
        h = dense(self.pwconv2, h, name="pwconv2", stats=stats, collect=collect)
        return x + self.gamma * h, stats


class ConvNeXt(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        self.cfg = cfg
        dims, eps = cfg.dims, cfg.ln_eps
        # FB's channels-first LayerNorms: the images here are NHWC, so they
        # normalise the last axis
        down = [nn.Sequential(nn.Conv2d(3, dims[0], 4, 4), nn.LayerNorm(dims[0], eps=eps))]
        down += [nn.Sequential(nn.LayerNorm(dims[i - 1], eps=eps),
                               nn.Conv2d(dims[i - 1], dims[i], 2, 2))
                 for i in range(1, len(dims))]
        self.downsample_layers = nn.ModuleList(down)
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(dim, eps) for _ in range(depth))
            for depth, dim in zip(cfg.depths, dims))
        self.norm = nn.LayerNorm(dims[-1], eps=eps)
        self.head = nn.Linear(dims[-1], cfg.num_classes)

    def downsample(self, si: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``si``'s downsample (classifiers.py:187-204): a patch matmul
        with the conv's flattened weight, the LayerNorm before it (si > 0) or
        after it (the stem)."""
        layers, eps = self.downsample_layers[si], self.cfg.ln_eps
        conv, ln = (layers[0], layers[1]) if si == 0 else (layers[1], layers[0])
        if si > 0:
            x = layer_norm(x, ln.weight, ln.bias, eps)
        w = conv.weight
        b, h, wd, _ = x.shape
        k = w.shape[-1]
        y = F.linear(extract_patches(x, k), w.reshape(w.shape[0], -1), conv.bias)
        y = y.reshape(b, h // k, wd // k, -1)
        return layer_norm(y, ln.weight, ln.bias, eps) if si == 0 else y

    def features(self, images: torch.Tensor, stages: Optional[int] = None) -> torch.Tensor:
        """NHWC images through the first ``stages`` stages (all by default),
        each its downsample and blocks."""
        x = images.to(self.head.weight.dtype)
        for si in range(len(self.stages) if stages is None else stages):
            x = self.downsample(si, x)
            for blk in self.stages[si]:
                x, _ = blk(x)
        return x

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, classes) float32 logits."""
        x = self.features(images).mean(dim=(1, 2))
        x = layer_norm(x, self.norm.weight, self.norm.bias, self.cfg.ln_eps)
        return logits_f32(x, self.head.weight) + self.head.bias.to(torch.float32)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Seeded random init with the JAX ``init_params`` stds, layer scale
        1e-6 (classifiers.py:116-157)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                normal_(mod.weight, 0.02, gen)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, ConvNeXtBlock):
                mod.gamma.fill_(1e-6)


def convnext_loss(model: ConvNeXt, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logp = torch.log_softmax(model(batch["image"]), dim=-1)
    return -logp.gather(-1, batch["label"][:, None].long())[:, 0]


def make_convnext_adapter(model: ConvNeXt) -> ModelAdapter:
    """One stack per stage, ``stages.{s}.blocks``, per-row masks; a stage's
    inputs are the stages before it and its own downsample
    (classifiers.py:223-260). No suffix plan: the serial cycle."""
    cfg = model.cfg
    stacks = []
    for si, depth in enumerate(cfg.depths):
        def prepare(m, batch, si=si):
            return m.downsample(si, m.features(batch["image"], si)), None

        stacks.append(StackSpec(f"stages.{si}.blocks", depth, CONVNEXT_LINEARS, True,
                                prepare, _block_forward, lambda m, si=si: m.stages[si]))
    return ModelAdapter(name="convnext", model=model, loss_fn=convnext_loss, stacks=stacks,
                        model_prefixes={s.name: "stages" for s in stacks})


# -- shared ----------------------------------------------------------------------------

Classifier = Union[eva_vit.EvaViT, ConvNeXt]


def _block_forward(block, x, cache, collect=None):
    return block(x, cache, collect=collect)


def build(model: str, scale: str) -> Union[eva_vit.EvaViTConfig, ConvNeXtConfig]:
    """The CLIs' config of ``deit`` / ``convnext`` at ``tiny`` / ``small`` /
    ``full`` (classifiers.py:61-79): ConvNeXt's ``small`` is ConvNeXt-T,
    DeiT's DeiT-S."""
    if model == "deit":
        if scale == "full":
            return deit_base()
        if scale == "small":
            return deit_small()
        return eva_vit.tiny_config(final_norm=True, head_dim=10, qkv_bias_mode="full")
    if model == "convnext":
        return convnext_tiny() if scale in ("full", "small") else tiny_config()
    raise ValueError(f"unknown classifier family {model!r}")


def num_classes(cfg) -> int:
    return cfg.num_classes if isinstance(cfg, ConvNeXtConfig) else cfg.head_dim


def build_model(cfg, *, device=None, dtype=torch.float32,
                seed: Optional[int] = 0) -> Classifier:
    """DeiT (an ``EvaViTConfig``) or ConvNeXt on ``device`` (the card unless
    ``"cpu"``) in ``dtype``, frozen; ``seed`` draws a random init from its
    own ``torch.Generator``, ``seed=None`` leaves the storage for a loader."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = (ConvNeXt(cfg) if isinstance(cfg, ConvNeXtConfig)
                 else eva_vit.EvaViT(cfg)).to(dtype)
    model = model.to_empty(device=dev)
    model.requires_grad_(False)
    model.eval()
    if seed is not None:
        model.init_(torch.Generator(device=dev).manual_seed(int(seed)))
    return model


def make_adapter(model: Classifier) -> ModelAdapter:
    return (make_convnext_adapter(model) if isinstance(model, ConvNeXt)
            else make_vit_classifier_adapter(model))
