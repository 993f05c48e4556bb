"""Zero-shot classification prompt templates (the port's own copy of
``ecoflap_tpu/data/prompts.py``).

``OPENAI_IMAGENET_TEMPLATES`` is the reference's 80-entry
``openai_imagenet_template`` table (clip_models/model.py:1175-1256, a public
constant: same entries, same order), the ensemble eva_model.py:530-544
builds the ImageNet zero-shot classifier from; ``IMAGENET_TEMPLATES_SUBSET``
the common 7-template subset; ``SIMPLE_TEMPLATE`` one prompt.
"""

from __future__ import annotations

from typing import List, Sequence

OPENAI_IMAGENET_TEMPLATES: List[str] = [
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a sculpture of a {}.",
    "a photo of the hard to see {}.",
    "a low resolution photo of the {}.",
    "a rendering of a {}.",
    "graffiti of a {}.",
    "a bad photo of the {}.",
    "a cropped photo of the {}.",
    "a tattoo of a {}.",
    "the embroidered {}.",
    "a photo of a hard to see {}.",
    "a bright photo of a {}.",
    "a photo of a clean {}.",
    "a photo of a dirty {}.",
    "a dark photo of the {}.",
    "a drawing of a {}.",
    "a photo of my {}.",
    "the plastic {}.",
    "a photo of the cool {}.",
    "a close-up photo of a {}.",
    "a black and white photo of the {}.",
    "a painting of the {}.",
    "a painting of a {}.",
    "a pixelated photo of the {}.",
    "a sculpture of the {}.",
    "a bright photo of the {}.",
    "a cropped photo of a {}.",
    "a plastic {}.",
    "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.",
    "a photo of the {}.",
    "a good photo of the {}.",
    "a rendering of the {}.",
    "a {} in a video game.",
    "a photo of one {}.",
    "a doodle of a {}.",
    "a close-up photo of the {}.",
    "a photo of a {}.",
    "the origami {}.",
    "the {} in a video game.",
    "a sketch of a {}.",
    "a doodle of the {}.",
    "a origami {}.",
    "a low resolution photo of a {}.",
    "the toy {}.",
    "a rendition of the {}.",
    "a photo of the clean {}.",
    "a photo of a large {}.",
    "a rendition of a {}.",
    "a photo of a nice {}.",
    "a photo of a weird {}.",
    "a blurry photo of a {}.",
    "a cartoon {}.",
    "art of a {}.",
    "a sketch of the {}.",
    "a embroidered {}.",
    "a pixelated photo of a {}.",
    "itap of the {}.",
    "a jpeg corrupted photo of the {}.",
    "a good photo of a {}.",
    "a plushie {}.",
    "a photo of the nice {}.",
    "a photo of the small {}.",
    "a photo of the weird {}.",
    "the cartoon {}.",
    "art of the {}.",
    "a drawing of the {}.",
    "a photo of the large {}.",
    "a black and white photo of a {}.",
    "the plushie {}.",
    "a dark photo of a {}.",
    "itap of a {}.",
    "graffiti of the {}.",
    "a toy {}.",
    "itap of my {}.",
    "a photo of a cool {}.",
    "a photo of a small {}.",
    "a tattoo of the {}.",
]

IMAGENET_TEMPLATES_SUBSET: List[str] = [
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
]

SIMPLE_TEMPLATE = ["a photo of a {}."]

TEMPLATE_SETS = {
    "full": OPENAI_IMAGENET_TEMPLATES,
    "subset": IMAGENET_TEMPLATES_SUBSET,
    "simple": SIMPLE_TEMPLATE,
}


def build_prompts(
    classnames: Sequence[str],
    templates: Sequence[str] = OPENAI_IMAGENET_TEMPLATES,
) -> List[str]:
    """Class-major prompt list (C·T entries) matching
    ``clip.zero_shot_classifier``'s reshape convention."""
    out: List[str] = []
    for name in classnames:
        clean = name.replace("_", " ")
        out.extend(t.format(clean) for t in templates)
    return out


def load_classnames(path: str) -> List[str]:
    """One classname per line (ImageNet synset order)."""
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]
