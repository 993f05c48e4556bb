"""EVA-CLIP configurations: build the program's model at a configuration's
sizes, and make a zero-shot mix's prompts and images from the seed. The
program is imported inside the functions only."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.weights import generator


def build(cfg: Dict, device, dtype):
    """The model with uninitialised storage."""
    from ecoflap_tpu_torch.models import clip, eva_vit

    c = clip.CLIPConfig(visual=None, text=clip.CLIPTextConfig(**cfg["text"]),
                        eva_visual=eva_vit.EvaViTConfig(**cfg["visual"]))
    return clip.build_model(c, device=device, dtype=dtype, seed=None)


def visual_linears(cfg: Dict) -> List[str]:
    return [f"visual.blocks.{i}.{ln}.weight" for i in range(cfg["visual"]["depth"])
            for ln in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")]


def prompts(cfg: Dict, mix: Dict, seed: int, device) -> torch.Tensor:
    """(classes, templates, context) ids: a start id (vocabulary - 2), word
    ids 1.. vocabulary - 3, the end-of-text id (vocabulary - 1, the largest,
    where the text tower pools), then 0; lengths drawn from
    ``prompt_tokens``, start and end included."""
    g = generator(seed, device, 3)
    t = cfg["text"]
    c, k, ctx, vocab = mix["num_classes"], mix["templates"], t["context_length"], t["vocab_size"]
    lo, hi = mix["prompt_tokens"]
    n = torch.randint(lo, hi + 1, (c, k, 1), generator=g, device=device)
    ids = torch.randint(1, vocab - 2, (c, k, ctx), generator=g, device=device)
    pos = torch.arange(ctx, device=device)[None, None, :]
    ids = torch.where(pos < n - 1, ids, 0)
    ids = torch.where(pos == n - 1, vocab - 1, ids)
    return torch.where(pos == 0, vocab - 2, ids)


def images(cfg: Dict, mix: Dict, seed: int, device) -> List[np.ndarray]:
    """``distinct_batches`` float32 NHWC batches of Gaussian images on the
    host, drawn on the card."""
    g = generator(seed, device, 4)
    s, b = cfg["visual"]["img_size"], mix["batch_size"]
    return [torch.randn((b, s, s, 3), generator=g, device=device).cpu().numpy()
            for _ in range(mix["distinct_batches"])]
