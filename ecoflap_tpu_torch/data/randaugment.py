"""RandAugment for the BLIP train processors (port of
``ecoflap_tpu/data/randaugment.py``, numpy and PIL only; reference
``LAVIS/lavis/processors/randaugment.py``, ``RandomAugment(2, 5,
isPIL=True, augs=[...10 ops...])`` of ``blip_processors.py:119``).

* ``N`` op names drawn uniformly with replacement from ``augs``, each applied
  with probability 0.5 at magnitude ``M``;
* level -> argument maps (randaugment.py:224-283): enhance factor
  ``(level/10)*1.8 + 0.1``; shear ``(level/10)*0.3`` and translate
  ``(level/10)*10`` px and rotate ``(level/10)*30`` degrees with a random
  sign; posterize ``int((level/10)*4)`` bits; solarize threshold
  ``int((level/10)*256)``; a (128, 128, 128) fill for the geometric ops.

The ops are PIL's (the reference's cv2 ops pin themselves to PIL's output),
posterize and solarize exact numpy tables; PIL is imported inside the call.
Every draw comes from the processor's own numpy Generator, in the JAX
module's order, so one seed gives the JAX module's arrays bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

MAX_LEVEL = 10
TRANSLATE_CONST = 10
FILL = (128, 128, 128)

# blip_image_train's op list (blip_processors.py:119-131)
BLIP_TRAIN_AUGS = [
    "Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
]

ALL_AUGS = [
    "Identity", "AutoContrast", "Equalize", "Rotate", "Solarize", "Color",
    "Contrast", "Brightness", "Sharpness", "ShearX", "TranslateX",
    "TranslateY", "Posterize", "ShearY",
]


def enhance_factor(level: float) -> float:
    """Enhance-op magnitude map (randaugment.py:224-228)."""
    return (level / MAX_LEVEL) * 1.8 + 0.1


def posterize_bits(level: float) -> int:
    return int((level / MAX_LEVEL) * 4)


def solarize_threshold(level: float) -> int:
    return int((level / MAX_LEVEL) * 256)


def posterize(arr: np.ndarray, bits: int) -> np.ndarray:
    """Exact table op: keep the top ``bits`` bits of each channel
    (randaugment.py posterize_func; PIL.ImageOps.posterize needs bits>=1,
    the reference allows 0 → all-black, so numpy it is)."""
    return np.bitwise_and(arr, np.uint8((255 << (8 - bits)) & 255))


def solarize(arr: np.ndarray, thresh: int) -> np.ndarray:
    """Exact table op: invert pixels >= thresh (PIL.ImageOps.solarize)."""
    table = np.arange(256)
    table = np.where(table < thresh, table, 255 - table)
    return table.clip(0, 255).astype(np.uint8)[arr]


class RandomAugment:
    """N-op random augmentation over uint8 HWC arrays or PIL images.

    Args mirror the reference class (randaugment.py:326-350): ``n`` ops at
    magnitude ``m``, each applied with prob 0.5. Returns the same kind it
    was given (array in → array out; PIL in → array out, matching the
    reference's isPIL behavior inside a transform pipeline).
    """

    def __init__(self, n: int = 2, m: int = 10,
                 augs: Optional[Sequence[str]] = None,
                 rng: Optional[np.random.Generator] = None):
        self.n, self.m = n, m
        self.augs = list(augs) if augs else list(ALL_AUGS)
        unknown = set(self.augs) - set(ALL_AUGS)
        if unknown:
            raise ValueError(f"unknown augment ops: {sorted(unknown)}")
        self.rng = rng or np.random.default_rng()

    # -- op application -----------------------------------------------------

    def _signed(self, magnitude: float) -> float:
        return -magnitude if self.rng.random() > 0.5 else magnitude

    def _apply(self, img, name: str, level: float):
        from PIL import Image, ImageEnhance, ImageOps

        if name == "Identity":
            return img
        if name == "AutoContrast":
            return ImageOps.autocontrast(img)
        if name == "Equalize":
            return ImageOps.equalize(img)
        if name in ("Brightness", "Contrast", "Color", "Sharpness"):
            enh = getattr(ImageEnhance, name)
            return enh(img).enhance(enhance_factor(level))
        if name == "Posterize":
            return Image.fromarray(posterize(np.asarray(img),
                                             posterize_bits(level)))
        if name == "Solarize":
            return Image.fromarray(solarize(np.asarray(img),
                                            solarize_threshold(level)))
        w, h = img.size
        if name == "Rotate":
            deg = (level / MAX_LEVEL) * 30
            deg = -deg if self.rng.random() < 0.5 else deg
            return img.rotate(deg, resample=Image.BILINEAR, fillcolor=FILL)
        if name in ("ShearX", "ShearY"):
            f = self._signed((level / MAX_LEVEL) * 0.3)
            # PIL AFFINE takes the output→input map; (1, f, 0, 0, 1, 0)
            # shears content the same direction as the reference's forward
            # cv2 matrix [[1, f, 0], [0, 1, 0]] (cv2 inverts internally)
            coeffs = ((1, -f, 0, 0, 1, 0) if name == "ShearX"
                      else (1, 0, 0, -f, 1, 0))
            return img.transform((w, h), Image.AFFINE, coeffs,
                                 resample=Image.BILINEAR, fillcolor=FILL)
        if name in ("TranslateX", "TranslateY"):
            off = self._signed((level / MAX_LEVEL) * TRANSLATE_CONST)
            # reference translate_x_func: out(x) = in(x + off) — content
            # moves LEFT for positive off; PIL's inverse map is the same form
            coeffs = ((1, 0, off, 0, 1, 0) if name == "TranslateX"
                      else (1, 0, 0, 0, 1, off))
            return img.transform((w, h), Image.AFFINE, coeffs,
                                 resample=Image.BILINEAR, fillcolor=FILL)
        raise AssertionError(name)

    # -- pipeline -----------------------------------------------------------

    def sample_ops(self) -> List[Tuple[str, float, float]]:
        names = self.rng.choice(self.augs, self.n)  # with replacement
        return [(str(op), 0.5, self.m) for op in names]

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        img = (image if isinstance(image, Image.Image)
               else Image.fromarray(np.asarray(image, np.uint8)))
        for name, prob, level in self.sample_ops():
            if self.rng.random() > prob:
                continue
            img = self._apply(img, name, level)
        return np.asarray(img)
