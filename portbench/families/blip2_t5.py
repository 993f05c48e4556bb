"""BLIP-2 FlanT5 configurations: build the program's model at a
configuration's sizes, and make the calibration batch of a mix from the
seed. The program is imported inside the functions only."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.weights import generator


def build(cfg: Dict, device, dtype):
    """(model with uninitialised storage, adapter)."""
    from ecoflap_tpu_torch.models import blip2, eva_vit, qformer, t5

    c = blip2.Blip2Config(vit=eva_vit.EvaViTConfig(**cfg["vit"]),
                          t5=t5.T5Config(**cfg["t5"]),
                          qformer=qformer.QFormerConfig(**cfg["qformer"]))
    model = blip2.build_model(c, device=device, dtype=dtype, seed=None)
    return model, blip2.make_adapter(model)


def calibration(cfg: Dict, mix: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{image (N, H, W, 3) float32, text_input_ids, text_input_mask, labels}
    on the card: Gaussian images, and captions of ``caption_words`` hashed
    words cut after a prefix of ``prefix_words`` words; the prefix and an
    end-of-sequence id (1) are the text input, the rest and an
    end-of-sequence id the labels, padded with 0 (input) and -100 (labels).
    Word ids are 2.. vocabulary - 1."""
    g = generator(seed, device, 2)
    n, size, vocab = mix["num_samples"], cfg["vit"]["img_size"], cfg["t5"]["vocab_size"]
    images = torch.randn((n, size, size, 3), generator=g, device=device)
    words = torch.randint(2, vocab, (n, mix["caption_words"]), generator=g, device=device)
    lo, hi = mix["prefix_words"]
    cut = torch.randint(lo, hi + 1, (n,), generator=g, device=device)

    def pack(ids, keep, length, pad):
        """ids where keep, then eos, then pad, to ``length``."""
        count = keep.sum(dim=1)
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        packed = torch.gather(ids, 1, order)
        out = torch.full((n, length), pad, dtype=torch.int64, device=device)
        width = min(ids.shape[1], length)
        pos = torch.arange(width, device=device)[None, :]
        out[:, :width] = torch.where(pos < count[:, None], packed[:, :width], pad)
        rows = torch.arange(n, device=device)
        out[rows, count.clamp_max(length - 1)] = 1
        return out

    pos = torch.arange(mix["caption_words"], device=device)[None, :]
    prefix = pos < cut[:, None]
    ids_in = pack(words, prefix, mix["text_input_len"], 0)
    labels = pack(words, ~prefix, mix["text_output_len"], -100)
    return {"image": images, "text_input_ids": ids_in,
            "text_input_mask": (ids_in != 0).to(torch.int64), "labels": labels}
