"""The evaluation image transform (port of ``ImageEvalProcessor`` of
``ecoflap_tpu/data/processors.py``; reference LAVIS
blip_processors.py:28-197): resize the shorter side (bicubic), centre crop,
normalise with the BLIP mean and std. NHWC float32 out; PIL resamples, and
is imported where it is used."""

from __future__ import annotations

import numpy as np

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
