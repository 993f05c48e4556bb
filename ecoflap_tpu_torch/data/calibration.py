"""Tokenizers and calibration batches for BLIP-2 and LLaMA (port of the
tokenizers and the VL and LM parts of ``ecoflap_tpu/data/calibration.py``).

* CC3M-style caption split: a random CHARACTER split point in
  ``[1, len(caption)//2]``; the prefix is the text input, the rest the
  target (prefix_language_pretraining.py:47-55).
* ``HashTokenizer``: a deterministic md5 word-hash tokenizer with an HF-like
  call, so every run works without downloaded vocab files; ``FileTokenizer``
  reads a local ``tokenizer.json`` (``load_t5_tokenizer`` picks one).
* One stacked batch of ``num_samples`` samples (leading dim = microbatches x
  batch size), what the pruning stages consume.
* LM calibration: random ``seqlen`` windows of one token stream (wanda's
  ``get_c4``), with the JAX package's numpy draws.

The values equal the JAX package's; integer fields are int64 tensors.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch


def split_prefix_suffix(text: str, rng: np.random.Generator):
    hi = max(len(text) // 2, 1)
    split = int(rng.integers(1, hi + 1))
    return text[:split], text[split:]


class _TokenizerBase:
    """Truncation, eos, padding, the mask and the batch call
    (calibration.py:38-68); a subclass gives ``_raw_ids(text)`` and its pad
    and eos ids."""

    pad_token_id: int
    eos_token_id: int

    def _raw_ids(self, text: str) -> List[int]:
        raise NotImplementedError

    def encode(self, text: str, max_length: int, add_eos: bool = True,
               pad: bool = True):
        ids = self._raw_ids(text)[: max_length - int(add_eos)]
        if add_eos:
            ids.append(self.eos_token_id)
        mask = [1] * len(ids)
        if not pad:
            return ids, mask
        n = max_length - len(ids)
        return ids + [self.pad_token_id] * n, mask + [0] * n

    def __call__(self, texts: Sequence[str], max_length: int = 32,
                 add_eos: bool = True, pad: bool = True):
        pairs = [self.encode(t, max_length, add_eos, pad=pad) for t in texts]
        ids, mask = [p[0] for p in pairs], [p[1] for p in pairs]
        if not pad:
            return ids, mask
        return np.asarray(ids, np.int64), np.asarray(mask, np.int64)


class HashTokenizer(_TokenizerBase):
    """ids: 0 = pad, 1 = eos, 2..vocab-1 hashed words."""

    def __init__(self, vocab_size: int = 32128, eos_token_id: int = 1,
                 pad_token_id: int = 0):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id

    def _word_id(self, w: str) -> int:
        h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
        return 2 + h % (self.vocab_size - 2)

    def _raw_ids(self, text: str) -> List[int]:
        return [self._word_id(w) for w in text.split()]

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{i}>" for i in ids
                        if i not in (self.pad_token_id, self.eos_token_id))


class FileTokenizer(_TokenizerBase):
    """A subword tokenizer from a local HF ``tokenizer.json``
    (calibration.py:96-185), e.g. the FlanT5 sentencepiece vocab the
    reference tokenizes with (blip2_t5.py:96). pad and eos ids: explicit
    ``pad_id``/``eos_id`` > the file's ``padding`` and ``post_processor``
    sections > conventional token strings > a loudly warned T5 guess
    (pad 0, eos 1)."""

    _PAD_STRINGS = ("<pad>", "[PAD]", "<|pad|>")
    _EOS_STRINGS = ("</s>", "[SEP]", "<|endoftext|>", "<eos>", "<|eot_id|>")

    def __init__(self, path: str, pad_id: Optional[int] = None,
                 eos_id: Optional[int] = None):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)
        self.path = path
        self.vocab_size = self._tok.get_vocab_size()
        cfg_pad, cfg_eos = self._ids_from_file_config(path)
        self.pad_token_id = self._resolve(pad_id, cfg_pad, self._PAD_STRINGS, 0, "pad")
        self.eos_token_id = self._resolve(eos_id, cfg_eos, self._EOS_STRINGS, 1, "eos")

    def _ids_from_file_config(self, path: str):
        """(pad_id, eos_id) the tokenizer.json declares: the ``padding``
        section's pad, and the last token of a TemplateProcessing
        post-processor's single-sequence template (the eos it appends)."""
        try:
            with open(path) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            return None, None
        pad = eos = None
        padding = spec.get("padding") or {}
        if isinstance(padding.get("pad_id"), int):
            pad = padding["pad_id"]
        elif isinstance(padding.get("pad_token"), str):
            pad = self._tok.token_to_id(padding["pad_token"])
        post = spec.get("post_processor") or {}
        if post.get("type") == "TemplateProcessing":
            single = post.get("single") or []
            name = ((single[-1] if single else {}).get("SpecialToken") or {}).get("id")
            if name is not None:
                ids = ((post.get("special_tokens") or {}).get(name) or {}).get("ids") or []
                eos = ids[0] if ids else self._tok.token_to_id(name)
        return pad, eos

    def _resolve(self, explicit, from_config, strings, default, kind):
        if explicit is not None:
            return explicit
        if from_config is not None:
            return from_config
        for s in strings:
            tid = self._tok.token_to_id(s)
            if tid is not None:
                return tid
        logging.getLogger(__name__).warning(
            "FileTokenizer(%s): could not determine the %s id from the file's "
            "padding/post-processor config or conventional token strings %s — "
            "GUESSING %s=%d (T5 convention). Pass pad_id/eos_id explicitly if "
            "this vocab uses different ids; wrong ids corrupt attention masks "
            "and EOS stopping.", self.path, kind, strings, kind, default)
        return default

    def _raw_ids(self, text: str) -> List[int]:
        # the file's post-processor may append its own eos: encode appends ours
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids
                                 if i not in (self.pad_token_id, self.eos_token_id)])


def tiny_tokenizer_path() -> str:
    """The package's tiny Unigram tokenizer (188 tokens, all of ASCII), a
    copy of the JAX package's: tests and the planted-answer eval drill."""
    return os.path.join(os.path.dirname(__file__), "assets", "tiny_unigram.json")


def load_t5_tokenizer(name: str = "google/flan-t5-xl", vocab_size: int = 32128,
                      path: Optional[str] = None):
    """The tokenizer at ``path``, else ``name`` from the local HF cache, else
    a loudly warned ``HashTokenizer`` (calibration.py:197-237): hash ids
    serve synthetic runs but make any accuracy number meaningless."""
    if path:
        return FileTokenizer(path)
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
    except (ImportError, OSError, ValueError):  # no transformers, or nothing cached
        logging.getLogger(__name__).warning(
            "No HF tokenizer cache for %r and no --tokenizer_path given: FALLING "
            "BACK TO HashTokenizer (md5 word hashing). Token ids will NOT match "
            "the real sentencepiece vocab — generation/eval text and any accuracy "
            "numbers are synthetic-only. Pass --tokenizer_path <tokenizer.json> "
            "for real tokenization.", name)
        return HashTokenizer(vocab_size=vocab_size)

    class _Wrap:
        eos_token_id = tok.eos_token_id
        pad_token_id = tok.pad_token_id
        vocab_size = tok.vocab_size

        def __call__(self, texts, max_length=32, add_eos=True):
            enc = tok(list(texts), padding="max_length", truncation=True,
                      max_length=max_length, return_tensors="np")
            return (enc["input_ids"].astype(np.int64),
                    enc["attention_mask"].astype(np.int64))

        def decode(self, ids):
            return tok.decode([i for i in ids if i != tok.pad_token_id],
                              skip_special_tokens=True)

    return _Wrap()


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


def build_text_calibration_batch(texts: Iterable[str], tokenizer,
                                 spec: CalibrationSpec, seed: int = 0
                                 ) -> Dict[str, torch.Tensor]:
    """C4-style prefix-LM batch of the standalone T5 path (calibration.py:
    285-308; reference c4_dataset.py:24-64): {input_ids, attn_mask, labels
    (-100 at pads)} on the CPU."""
    rng = np.random.default_rng(seed)
    prefixes, suffixes = [], []
    for t in texts:
        if len(prefixes) >= spec.num_samples:
            break
        pre, suf = split_prefix_suffix(t, rng)
        prefixes.append(pre)
        suffixes.append(suf if suf.strip() else pre)
    in_ids, in_mask = tokenizer(prefixes, max_length=spec.text_input_len)
    out_ids, out_mask = tokenizer(suffixes, max_length=spec.text_output_len)
    labels = np.where(out_mask > 0, out_ids, -100)
    return {
        "input_ids": torch.from_numpy(in_ids),
        "attn_mask": torch.from_numpy(in_mask),
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
