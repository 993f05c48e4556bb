"""EVA ViT-g, BLIP-2's frozen vision tower and EVA-CLIP's visual tower (port
of ``ecoflap_tpu/models/eva_vit.py``; reference LAVIS/lavis/models/eva_vit.py).

BLIP-2's tower: depth 39, width 1408, 16 heads, patch 14, fused qkv with
separate q/v biases (no k bias), absolute position embedding, no final norm;
it returns every token. BLIP-1's ViT-B/16 (``qkv_bias_mode="full"``, one
fused qkv bias) applies ``norm`` to every token (``models/blip1.py``).
EVA-CLIP-g's (``eva_clip_g_visual``): depth 40, then
the cls token through a final LayerNorm (``norm``) and a linear ``head`` to
the 1024-d joint space (eva_vit.py:56-57, 147-152, 248-262). Patch embedding is
one matmul over extracted patches; the weight keeps the reference's Conv2d
shape and name (``patch_embed.proj.weight``). Images are NHWC, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ecoflap_tpu_torch.models.layers import (
    attention,
    collect_stats,
    dense,
    extract_patches,
    full_param,
    gelu,
    layer_norm,
    linear,
)

# prunable linears per block, reference-local names (wanda_pruner.py:499-568)
LINEAR_NAMES = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


@dataclass(frozen=True)
class EvaViTConfig:
    img_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_hidden: int = 6144
    in_chans: int = 3
    final_norm: bool = False  # EVA-CLIP: LayerNorm before the head
    head_dim: int = 0  # EVA-CLIP: linear head to the joint space (0: none)
    ln_eps: float = 1e-6
    # "eva": fused qkv, separate q/v biases, no k bias (eva_vit.py:79-85);
    # "full": fused qkv with one full bias (timm / BLIP ViT-B)
    qkv_bias_mode: str = "eva"

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1


def eva_vit_g(img_size: int = 224) -> EvaViTConfig:
    return EvaViTConfig(img_size=img_size)


def eva_clip_g_visual(img_size: int = 224, embed_dim: int = 1024) -> EvaViTConfig:
    """EVA-CLIP-g's visual tower (EVA-CLIP-g.json, eva_model.py:300-304)."""
    return EvaViTConfig(img_size=img_size, depth=40, final_norm=True,
                        head_dim=embed_dim)


def vit_base_config(img_size: int = 224, **kw) -> EvaViTConfig:
    """ViT-B/16 dims in the EVA block ('--model_scale small')."""
    defaults = dict(img_size=img_size, patch_size=16, embed_dim=768, depth=12,
                    num_heads=12, mlp_hidden=3072)
    defaults.update(kw)
    return EvaViTConfig(**defaults)


def tiny_config(**kw) -> EvaViTConfig:
    defaults = dict(img_size=16, patch_size=4, embed_dim=32, depth=3,
                    num_heads=4, mlp_hidden=64)
    defaults.update(kw)
    return EvaViTConfig(**defaults)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EvaViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, d: int, full_bias: bool = False):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, bias=full_bias)
        if not full_bias:
            self.q_bias = nn.Parameter(torch.empty(d))
            self.v_bias = nn.Parameter(torch.empty(d))
        self.proj = nn.Linear(d, d)

    def qkv_bias(self) -> torch.Tensor:
        """The fused qkv's bias: the full vector, or [q_bias, 0, v_bias]
        (eva_vit.py:123-128)."""
        if self.qkv.bias is not None:
            return self.qkv.bias
        q_bias, v_bias = full_param(self, "q_bias"), full_param(self, "v_bias")
        return torch.cat([q_bias, torch.zeros_like(q_bias), v_bias])


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class Block(nn.Module):
    """Pre-LN attention + pre-LN MLP, both residual (eva_vit.py:155-185)."""

    def __init__(self, cfg: EvaViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = Attention(d, cfg.qkv_bias_mode == "full")
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = Mlp(d, cfg.mlp_hidden)

    def forward(self, x: torch.Tensor, cache=None, collect: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        del cache
        cfg, a, m = self.cfg, self.attn, self.mlp
        stats: Dict[str, torch.Tensor] = {}
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, cfg.ln_eps)
        collect_stats(stats, "attn.qkv", h, collect)
        q, k, v = linear(h, a.qkv, a.qkv_bias()).chunk(3, dim=-1)
        o = attention(q, k, v, cfg.num_heads)
        x = x + dense(a.proj, o, name="attn.proj", stats=stats, collect=collect)
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, cfg.ln_eps)
        h = gelu(dense(m.fc1, h, name="mlp.fc1", stats=stats, collect=collect))
        h = dense(m.fc2, h, name="mlp.fc2", stats=stats, collect=collect)
        return x + h, stats


class EvaViT(nn.Module):
    def __init__(self, cfg: EvaViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps) if cfg.final_norm else None
        self.head = nn.Linear(d, cfg.head_dim) if cfg.head_dim else None

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, N+1, D) tokens: patch embed + cls +
        position embedding, in the tower's weight dtype."""
        w = self.patch_embed.proj.weight
        patches = extract_patches(images.to(w.dtype), self.cfg.patch_size)
        x = linear(patches, self.patch_embed.proj, weight=w.reshape(w.shape[0], -1))
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        return torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        x = self.embed(images)
        for blk in self.blocks:
            x, _ = blk(x)
        return x

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """BLIP-2's tower: every token. EVA-CLIP's: the cls token through
        ``norm`` and ``head`` (eva_vit.py:248-262)."""
        x = self.forward_features(images)
        if self.norm is None and self.head is None:
            return x
        x = x[:, 0]
        if self.norm is not None:
            x = layer_norm(x, self.norm.weight, self.norm.bias, self.cfg.ln_eps)
        if self.head is not None:
            x = dense(self.head, x)
        return x

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Seeded random init with the JAX ``init_params`` stds."""
        cfg = self.cfg
        patch_in = cfg.in_chans * cfg.patch_size ** 2
        normal_(self.patch_embed.proj.weight, patch_in ** -0.5, gen)
        self.patch_embed.proj.bias.zero_()
        normal_(self.cls_token, 0.02, gen)
        normal_(self.pos_embed, 0.02, gen)
        for blk in self.blocks:
            for norm in (blk.norm1, blk.norm2):
                norm.weight.fill_(1.0)
                norm.bias.zero_()
            normal_(blk.attn.qkv.weight, 0.02, gen)
            if blk.attn.qkv.bias is not None:
                blk.attn.qkv.bias.zero_()
            else:
                blk.attn.q_bias.zero_()
                blk.attn.v_bias.zero_()
            for lin in (blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                normal_(lin.weight, 0.02, gen)
                lin.bias.zero_()
        if self.norm is not None:
            self.norm.weight.fill_(1.0)
            self.norm.bias.zero_()
        if self.head is not None:
            normal_(self.head.weight, 0.02, gen)
            self.head.bias.zero_()


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill ``t`` with float32 N(0, std^2) draws from ``gen``, cast once."""
    z = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
    t.copy_(z * std)
