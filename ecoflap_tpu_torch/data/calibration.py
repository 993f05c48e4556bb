"""Calibration batches for BLIP-2 and LLaMA (port of the VL and LM parts
of ``ecoflap_tpu/data/calibration.py``).

* CC3M-style caption split: a random CHARACTER split point in
  ``[1, len(caption)//2]``; the prefix is the text input, the rest the
  target (prefix_language_pretraining.py:47-55).
* ``HashTokenizer``: a deterministic md5 word-hash tokenizer with an HF-like
  call, so every run works without downloaded vocab files.
* One stacked batch of ``num_samples`` samples (leading dim = microbatches x
  batch size), what the pruning stages consume.
* LM calibration: random ``seqlen`` windows of one token stream (wanda's
  ``get_c4``), with the JAX package's numpy draws.

The values equal the JAX package's; integer fields are int64 tensors.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Sequence

import numpy as np
import torch


def split_prefix_suffix(text: str, rng: np.random.Generator):
    hi = max(len(text) // 2, 1)
    split = int(rng.integers(1, hi + 1))
    return text[:split], text[split:]


class HashTokenizer:
    """ids: 0 = pad, 1 = eos, 2..vocab-1 hashed words."""

    def __init__(self, vocab_size: int = 32128, eos_token_id: int = 1,
                 pad_token_id: int = 0):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id

    def _word_id(self, w: str) -> int:
        h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
        return 2 + h % (self.vocab_size - 2)

    def encode(self, text: str, max_length: int, add_eos: bool = True):
        ids = [self._word_id(w) for w in text.split()][: max_length - int(add_eos)]
        if add_eos:
            ids.append(self.eos_token_id)
        n = max_length - len(ids)
        return ids + [self.pad_token_id] * n, [1] * len(ids) + [0] * n

    def __call__(self, texts: Sequence[str], max_length: int = 32,
                 add_eos: bool = True):
        pairs = [self.encode(t, max_length, add_eos) for t in texts]
        return (np.asarray([p[0] for p in pairs], np.int64),
                np.asarray([p[1] for p in pairs], np.int64))


@dataclass
class CalibrationSpec:
    num_samples: int = 128
    batch_size: int = 8
    text_input_len: int = 32
    text_output_len: int = 32

    @property
    def num_microbatches(self) -> int:
        return max(1, self.num_samples // self.batch_size)


def build_vl_calibration_batch(samples: Iterable[Dict[str, Any]], tokenizer,
                               spec: CalibrationSpec, seed: int = 0
                               ) -> Dict[str, torch.Tensor]:
    """[{image: (H, W, 3) float array, caption: str}] -> {image (NHWC float32),
    text_input_ids, text_input_mask, labels (-100 at pads)} on the CPU."""
    rng = np.random.default_rng(seed)
    images, prefixes, suffixes = [], [], []
    for s in samples:
        if len(images) >= spec.num_samples:
            break
        pre, suf = split_prefix_suffix(s["caption"], rng)
        images.append(np.asarray(s["image"]))
        prefixes.append(pre)
        suffixes.append(suf if suf.strip() else pre)
    if not images:
        raise ValueError("no calibration samples")
    in_ids, in_mask = tokenizer(prefixes, max_length=spec.text_input_len)
    out_ids, out_mask = tokenizer(suffixes, max_length=spec.text_output_len)
    labels = np.where(out_mask > 0, out_ids, -100)
    return {
        "image": torch.from_numpy(np.stack(images)),
        "text_input_ids": torch.from_numpy(in_ids),
        "text_input_mask": torch.from_numpy(in_mask),
        "labels": torch.from_numpy(labels.astype(np.int64)),
    }


def build_lm_calibration_batch(token_stream: np.ndarray, num_samples: int,
                               seqlen: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """{input_ids: (num_samples, seqlen) int64} of random windows of one
    token stream (calibration.py:311-323), on the CPU."""
    rng = np.random.default_rng(seed)
    n = token_stream.shape[0]
    starts = rng.integers(0, max(n - seqlen, 1), size=num_samples)
    windows = np.stack([token_stream[s:s + seqlen] for s in starts])
    return {"input_ids": torch.from_numpy(windows.astype(np.int64))}


def synthetic_token_stream(num_samples: int, seqlen: int, vocab_size: int,
                           seed: int = 0) -> np.ndarray:
    """The JAX CLI's synthetic stream (cli/prune.py:497-500): ids in
    [2, vocab), room for ``num_samples`` windows and one more."""
    rng = np.random.default_rng(seed)
    return rng.integers(2, vocab_size, size=(num_samples * seqlen + seqlen,))


def synthetic_vl_samples(n: int, img_size: int, seed: int = 0,
                         words: int = 12) -> List[Dict[str, Any]]:
    """Random images and captions for smoke and benchmark runs."""
    rng = np.random.default_rng(seed)
    vocab = ["dog", "cat", "tree", "house", "red", "blue", "runs", "sits",
             "park", "sky", "ball", "girl", "boy", "water", "bird"]
    out = []
    for _ in range(n):
        cap = " ".join(rng.choice(vocab, size=words))
        out.append({
            "image": rng.normal(size=(img_size, img_size, 3)).astype(np.float32),
            "caption": cap,
        })
    return out
