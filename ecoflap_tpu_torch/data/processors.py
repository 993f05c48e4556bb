"""Image transforms and text cleaning (port of
``ecoflap_tpu/data/processors.py``; reference LAVIS
blip_processors.py:28-197, clip_processors.py:19-62): the evaluation
transform (resize the shorter side, bicubic, centre crop, normalise with the
BLIP mean and std), the train transforms (random resized crop, flip, and for
``blip_image_train`` RandAugment) and the caption and question cleaners.
NHWC float32 out; PIL resamples, and is imported where it is used. Every
random draw comes from the processor's numpy Generator in the JAX module's
order, so one seed gives the same arrays.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ecoflap_tpu_torch.core.registry import registry

BLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
BLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _to_pil(image):
    from PIL import Image

    if isinstance(image, Image.Image):
        return image
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(arr)


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


class ImageEvalProcessor:
    """Resize(image_size, bicubic) -> centre crop -> normalise; (H, W, 3) out."""

    def __init__(self, image_size: int = 224, mean=BLIP_MEAN, std=BLIP_STD):
        self.image_size = image_size
        self.mean, self.std = mean, std

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        img = _to_pil(image).convert("RGB")
        s = self.image_size
        w, h = img.size
        scale = s / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
        w, h = img.size
        left, top = (w - s) // 2, (h - s) // 2
        img = img.crop((left, top, left + s, top + s))
        return _normalize(np.asarray(img), self.mean, self.std)


class ImageTrainProcessor:
    """RandomResizedCrop + horizontal flip [+ RandAugment] + normalise
    (processors.py:65-118). ``blip_image_train`` inserts ``RandomAugment(2,
    5)`` over its 10-op list after the flip; ``blip2_image_train`` is crop
    and flip only."""

    def __init__(self, image_size: int = 224, mean=BLIP_MEAN, std=BLIP_STD,
                 min_scale: float = 0.5, max_scale: float = 1.0,
                 seed: Optional[int] = None, use_randaugment: bool = False,
                 randaugment_n: int = 2, randaugment_m: int = 5):
        self.image_size = image_size
        self.mean, self.std = mean, std
        self.min_scale, self.max_scale = min_scale, max_scale
        self.rng = np.random.default_rng(seed)
        self.randaugment = None
        if use_randaugment:
            from ecoflap_tpu_torch.data.randaugment import BLIP_TRAIN_AUGS, RandomAugment

            self.randaugment = RandomAugment(
                randaugment_n, randaugment_m, BLIP_TRAIN_AUGS, rng=self.rng)

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        img = _to_pil(image).convert("RGB")
        w, h = img.size
        area = w * h
        for _ in range(10):
            target = area * self.rng.uniform(self.min_scale, self.max_scale)
            ar = self.rng.uniform(3 / 4, 4 / 3)
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                left = int(self.rng.integers(0, w - cw + 1))
                top = int(self.rng.integers(0, h - ch + 1))
                img = img.crop((left, top, left + cw, top + ch))
                break
        img = img.resize((self.image_size, self.image_size), Image.BICUBIC)
        if self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(img)
        if self.randaugment is not None:
            arr = self.randaugment(arr)
        return _normalize(arr, self.mean, self.std)


class BlipImageTrainProcessor(ImageTrainProcessor):
    """blip_image_train: RandAugment on by default (the UPop fine-tuning
    transform)."""

    def __init__(self, *args, use_randaugment: bool = True, **kw):
        super().__init__(*args, use_randaugment=use_randaugment, **kw)


class CaptionProcessor:
    """blip_caption: lowercase, punctuation to spaces, collapse spaces,
    truncate to ``max_words`` (blip_processors.py pre_caption)."""

    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption).rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return self.prompt + caption


class QuestionProcessor:
    """blip_question: lowercase, punctuation dropped ('?' kept), truncate
    to ``max_words`` (blip_processors.py pre_question)."""

    def __init__(self, max_words: int = 50):
        self.max_words = max_words

    def __call__(self, question: str) -> str:
        question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
        question = question.rstrip(" ")
        words = question.split(" ")
        if len(words) > self.max_words:
            question = " ".join(words[: self.max_words])
        return question


registry.register("processor", "blip_image_eval", ImageEvalProcessor)
registry.register("processor", "blip_image_train", BlipImageTrainProcessor)
registry.register("processor", "blip2_image_train", ImageTrainProcessor)
registry.register("processor", "clip_image_eval", ImageEvalProcessor)
registry.register("processor", "blip_caption", CaptionProcessor)
registry.register("processor", "blip_question", QuestionProcessor)
